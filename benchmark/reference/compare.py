"""The numbers that decide ``correct``, each the worst over the outputs
compared, and each held to its limit in ``limits/<cell>.json``.

Sampling (``sample_numbers``), per kept job:

* ``pe_gap``: the widest gap between a potential the program returned
  (every draw's, and the final state's) and the reference's at the same
  point, as a share of the potential's magnitude (the sum of its terms'
  absolute values, at least 1): the kernel's potential, the driver's
  thinning and collection;
* ``frozen_share``: the share of chains whose draws and final position
  never moved: a transition that leaves its state unchanged;
* ``clock_gap``: the final state's clock less the steps asked for
  (warmup + samples), exactly 0;
* ``accept_gap`` (ARWMH): the median chain's mean acceptance over the
  sampling steps less the adaptation's target 0.234;
* ``law_gap``: the widest gap between the pooled draws' per-coordinate
  mean, sd and 5, 25, 50, 75 and 95% quantiles and those of a reference
  sample, in the reference's sd of that coordinate (``arwmh.law_gap``):
  the transition itself (proposal, accept test, adaptation).  The
  traffic's ``law`` names the reference sample: ``"gold"``, the
  configuration's reference posterior draws, where the cell's budget
  reaches the posterior (its ``law_burn``, the share of each chain's
  draws before it does, is left out); ``"arwmh"``, the plain ARWMH
  (``reference/arwmh.py``) run from the same initial law at the same
  budget and chains, where it does not.

Grading (``grade_numbers``), over every set of each kept job:

* ``w_gap``: |W − exact W| over the auction's stated bound ε_final =
  range / (2n), with the range the largest of the batch's cost matrices';
* ``mmd_gap``, ``rmse_gap``: |program − reference| / reference."""

from __future__ import annotations

import numpy as np

import json
from pathlib import Path

from benchmark.reference import arwmh, grade, potentials


def _finite(v: float) -> float:
    return float(v) if np.isfinite(v) else float("inf")


_LAW: dict = {}


def law_sample(config: dict, traffic: dict, seed: int, device,
               dtype: str = "float64") -> np.ndarray:
    """The draws that the program's draws are held against (traffic's
    ``law``), in ``dtype``: the gold rounded to it, or the plain ARWMH run
    in it (the float64 sample of the last seed kept for the control)."""
    key = (config["name"], json.dumps(traffic, sort_keys=True), seed, dtype)
    if key not in _LAW:
        if dtype == "float64":
            _LAW.clear()
        _LAW[key] = _law_sample(config, traffic, seed, device, dtype)
    return _LAW[key]


def _law_sample(config: dict, traffic: dict, seed: int, device,
                dtype: str) -> np.ndarray:
    import torch

    if traffic["law"] == "gold":
        gold = np.load(Path(config["data_dir"]) / config["gold"])
        return torch.as_tensor(np.asarray(gold, np.float64)).to(
            getattr(torch, dtype)).to(torch.float64).numpy()
    return arwmh.run(config, int(traffic["chains"]),
                     int(traffic["num_warmup"]), int(traffic["num_samples"]),
                     int(traffic["thinning"]), seed, dtype=dtype,
                     device=device)["x"]


def sample_numbers(outputs: list, config: dict, traffic: dict,
                   dtype: str = "float64", seed: int = 0,
                   device="cpu") -> dict:
    """The sampling numbers over the jobs' outputs.  With ``dtype`` other
    than float64 the reference in that dtype is put in the program's
    place: its potential at the program's draws, its law sample against
    the float64 one (the control).  ``seed`` seeds the reference
    sampler."""
    steps = int(traffic["num_warmup"]) + int(traffic["num_samples"])
    worst = {}
    law = None
    if "law" in traffic and outputs:
        law = law_sample(config, traffic, seed, device)
        if dtype != "float64":
            low = law_sample(config, traffic, seed + 1, device, dtype)
            worst["law_gap"] = _finite(arwmh.law_gap(low, law))
    for o in outputs:
        x = np.asarray(o["x"], np.float64)                 # (C, F, d)
        d = x.shape[2]
        pts = np.concatenate([x.reshape(-1, d), o["x_last"]])
        pe = np.concatenate([np.asarray(o["pe"]).reshape(-1), o["pe_last"]])
        ref, mag = potentials.potential(config, pts, magnitude=True)
        if dtype != "float64":
            pe = potentials.potential(config, pts, dtype)
        still = np.all(x == x[:, :1], axis=(1, 2)) & np.all(
            o["x_last"] == x[:, 0], axis=1)
        got = {"pe_gap": np.max(np.abs(pe - ref) / np.maximum(1.0, mag)),
               "frozen_share": still.mean(),
               "clock_gap": abs(o["i"] - steps)}
        if "map" in o:
            got["accept_gap"] = abs(float(np.median(o["map"])) - 0.234)
        if law is not None and dtype == "float64":
            burn = int(x.shape[1] * float(traffic.get("law_burn", 0)))
            got["law_gap"] = arwmh.law_gap(x[:, burn:], law)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), _finite(v))
    return worst


def grade_numbers(outputs: list, gold: np.ndarray, batch: int,
                  dtype: str = "float64") -> dict:
    """The grading numbers over the kept jobs.  Each output holds the
    job's sets (S, n, d), graded in batches of ``batch``, and the
    program's columns.  With ``dtype`` other than float64 the columns
    compared are the reference's in that dtype (the control)."""
    mmd = grade.MMD(gold)
    mmd_low = grade.MMD(gold, dtype) if dtype != "float64" else None
    worst = dict(w_gap=0.0, mmd_gap=0.0, rmse_gap=0.0)
    if not outputs:
        return {k: float("inf") for k in worst}
    for o in outputs:
        sets, cols = o["sets"], o["columns"]
        n = sets.shape[1]
        ranges = [grade.cost_range(x, gold) for x in sets]
        for s in range(len(sets)):
            b0 = (s // batch) * batch
            rng = max(ranges[b0:b0 + batch])
            w_ref = grade.exact_w(sets[s], gold)
            w = cols["wasserstein"][s] if dtype == "float64" else \
                grade.exact_w(sets[s], gold, dtype)
            m_ref = mmd(sets[s])
            m = cols["mmd"][s] if dtype == "float64" else mmd_low(sets[s])
            r_ref = grade.rmse_means(sets[s], gold)
            r = cols["rmse_means"][s] if dtype == "float64" else \
                grade.rmse_means(sets[s], gold, dtype)
            for k, v in (("w_gap", abs(w - w_ref) / (max(rng, 1e-6)
                                                     / (2.0 * n))),
                         ("mmd_gap", abs(m - m_ref) / m_ref),
                         ("rmse_gap", abs(r - r_ref) / r_ref)):
                worst[k] = max(worst[k], _finite(v))
    return worst
