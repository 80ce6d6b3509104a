"""Per-target posterior figure families built from the harness's saved
runs (PyTorch): the counterpart of
``adaptive_mcmc_tpu/analysis/artifact_figures.py``, split in two as
``analysis.figures`` is.

The families, over the port's run root (``RUNS``, by default
``experiments.configs.OUT_ROOT``: ``lr_decay/**`` and ``w_eval/**``):

* lr-decay PE overlays (mean and 90% band over the seeds, PE shifted by
  ``pe_offset``, the gold draws' 90% band as guides);
* lr-decay adaptation-drift overlays with the n^(-1/2) guide;
* φ-estimator convergence bands (eight schools: min_j θ_j; diamonds: the
  uncentered intercept);
* the metric boxplots with the aggregate table;
* kidiq's posterior predictive over a mom_iq grid.

``data_*`` reads the artifacts and reduces them on ``device`` (the card by
default) into a dict of numpy arrays, or returns None when its input
artifacts are missing; ``draw_*`` draws it with matplotlib (imported only
there) into the JAX package's file names.  The aggregate CSV has the
layout and the numbers of pandas' ``groupby().agg(["mean", "std"])
.to_csv`` on the eval CSVs as ``pd.read_csv`` reads them, without pandas.

Run:  python -m adaptive_mcmc_tpu_torch.analysis.artifact_figures
[img_dir] [--runs DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.analysis.posterior import pe_offset
from adaptive_mcmc_tpu_torch.experiments.configs import OUT_ROOT
from adaptive_mcmc_tpu_torch.experiments.runner import TARGETS

Tensor = torch.Tensor

RUNS = Path(OUT_ROOT)
OUT_DIR = Path(OUT_ROOT) / "img"
DECAY_LABELS = [(0.5, r"\frac{1}{2}"), (2 / 3, r"\frac{2}{3}"), (1.0, "1")]
DECAY_COLORS = ("C0", "C1", "C2")
LR_TARGETS = {
    "eight_schools": "eight_schools_centered",
    "diamonds": "diamonds",
    "kidiq": "kidiq",
}
# output file names follow the reference img/svg inventory exactly
FIG_KERNEL = {"arwmh": "rwm", "asss": "sss", "nuts": "nuts"}
PHI_KERNEL = {"arwmh": "arwm", "asss": "asss", "nuts": "nuts"}
FIG_TARGET = {"eight_schools": "eight-schools", "diamonds": "diamonds",
              "kidiq": "kidiq"}
PHI_COLORS = (("arwmh", "C3"), ("asss", "C4"), ("nuts", "C5"))
METRICS = ("rmse_means", "wasserstein", "mmd")
BOX_COLORS = ("#c44e52", "#8172b3", "#937860")   # seaborn "deep" [3:6]


def _runs(runs) -> Path:
    return Path(RUNS if runs is None else runs)


def _on(x, device) -> Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                           device=device)


def _q(x: Tensor, q: float, dim: int = 0) -> np.ndarray:
    return torch.quantile(x.to(torch.float64), q, dim=dim).cpu().numpy()


def _gold(target_name: str, runs=None) -> Optional[np.ndarray]:
    """The vendored gold draws (``experiments.evaluate``), else a cached
    NUTS reference run under the run root's ``reference_draws/``."""
    from adaptive_mcmc_tpu_torch.experiments.evaluate import (
        vendored_gold_draws,
    )

    g = vendored_gold_draws(target_name)
    if g is not None:
        return np.asarray(g)
    f = _runs(runs) / "reference_draws" / f"{target_name}_nuts.npy"
    return np.load(f) if f.exists() else None


def _lr_npz(lr_target: str, kernel: str, decay: float, runs=None):
    f = _runs(runs) / "lr_decay" / lr_target / kernel \
        / f"decay_{decay:.4g}.npz"
    if not f.exists():
        return None
    with np.load(f) as d:
        return {k: d[k] for k in d.files}


def _lr_runs(target_name: str, kernel: str, runs) -> Optional[dict]:
    lr = {d: _lr_npz(LR_TARGETS[target_name], kernel, d, runs)
          for d, _ in DECAY_LABELS}
    return None if any(v is None for v in lr.values()) else lr


def _bands(x: Tensor, prefix: str, qs=(0.05, 0.95)) -> dict:
    """Mean over the seeds (axis 0) and the quantile bands of ``x``."""
    out = {f"{prefix}.mean": torch.mean(x, dim=0).cpu().numpy()}
    for q in qs:
        out[f"{prefix}.q{round(q * 100):02d}"] = _q(x, q)
    return out


def data_lr_decay_pe(target_name: str, kernel: str, runs=None,
                     device="cuda") -> Optional[dict]:
    """PE traces on the log grid per lr_decay: mean and 90% band over the
    seeds after the ``pe_offset`` shift, the gold draws' 90% band in the
    lr-decay model's parametrization, the y-limits."""
    lr_target = LR_TARGETS[target_name]
    target = TARGETS[lr_target]()
    gold = _gold(target_name, runs)
    lr = _lr_runs(target_name, kernel, runs)
    if gold is None or lr is None:
        return None
    gold_pe = None
    if lr_target == target_name and gold.shape[1] == target.dim:
        gold_pe = target.potential_fn(_on(gold, device))
    elif target_name == "eight_schools":
        # the gold draws live in the noncentered space [mu, log_tau,
        # theta_base]; the centered posterior is their pushforward under
        # theta = mu + tau * theta_base
        mu, lt, tb = gold[:, :1], gold[:, 1:2], gold[:, 2:]
        centered = np.concatenate([mu, lt, mu + np.exp(lt) * tb], axis=1)
        gold_pe = target.potential_fn(_on(centered, device))
    out = {"ns": np.asarray(lr[1.0]["i"])}
    for decay, _ in DECAY_LABELS:
        pes = _on(lr[decay]["potential_energy"], device).T   # (seeds, T)
        off = pe_offset(gold_pe) if gold_pe is not None \
            else pe_offset(pes[:, -50:].reshape(-1))
        out.update(_bands(pes - off, f"a{decay:.4g}"))
        if gold_pe is not None:
            out[f"a{decay:.4g}.gold"] = np.asarray(
                [_q(gold_pe - off, q) for q in (0.05, 0.95)])
    last = _on(lr[1.0]["potential_energy"][-100:], device).reshape(-1)
    out["ylim"] = np.asarray([_q(last, 0.01), _q(last, 0.99)])
    return out


def draw_lr_decay_pe(data: dict, target_name: str, kernel: str,
                     out_dir: Path) -> None:
    plt = _plt()
    ns = data["ns"]
    fig, ax = plt.subplots(figsize=(6.5, 4.2))
    for (decay, lab), color in zip(DECAY_LABELS, DECAY_COLORS):
        a = f"a{decay:.4g}"
        ax.plot(ns, data[f"{a}.mean"], color=color, label=rf"$a={lab}$")
        ax.fill_between(ns, data[f"{a}.q05"], data[f"{a}.q95"], alpha=0.2,
                        color=color)
        if f"{a}.gold" in data:
            ax.hlines(data[f"{a}.gold"], 1, ns[-1], linestyles="--",
                      color="gray", alpha=0.5)
    ax.set_xscale("log")
    ax.set_xlabel(r"step $n$")
    ax.set_ylabel(r"potential energy $U_n$")
    lo, hi = data["ylim"]
    ax.set_ylim(lo - 5, hi + 25)
    ax.legend(loc="upper right")
    _save(fig, out_dir,
          f"{FIG_KERNEL[kernel]}-pe-lr-{FIG_TARGET[target_name]}")


def data_lr_decay_adaptation(target_name: str, kernel: str, runs=None,
                             device="cuda") -> Optional[dict]:
    """Adaptation drift d_n per lr_decay: mean and 90% band over the
    seeds on the log grid."""
    lr = _lr_runs(target_name, kernel, runs)
    if lr is None:
        return None
    out = {"ns": np.asarray(lr[1.0]["i"])}
    for decay, _ in DECAY_LABELS:
        out.update(_bands(_on(lr[decay]["as_change"], device).T,
                          f"a{decay:.4g}"))
    return out


def draw_lr_decay_adaptation(data: dict, target_name: str, kernel: str,
                             out_dir: Path) -> None:
    plt = _plt()
    ns = data["ns"]
    fig, ax = plt.subplots(figsize=(6.5, 4.2))
    for (decay, lab), color in zip(DECAY_LABELS, DECAY_COLORS):
        a = f"a{decay:.4g}"
        ax.plot(ns, data[f"{a}.mean"], color=color, label=rf"$a={lab}$")
        ax.fill_between(ns, data[f"{a}.q05"], data[f"{a}.q95"], alpha=0.2,
                        color=color)
    ax.plot(ns, 1.0 / np.sqrt(ns), "--", color="gray",
            label=r"$n^{-\frac{1}{2}}$")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_ylim(bottom=1e-6)
    ax.set_xlabel(r"step $n$")
    ax.set_ylabel(r"adaptation changes $d_n$")
    ax.legend(loc="lower left")
    _save(fig, out_dir,
          f"{FIG_KERNEL[kernel]}-adaptation-lr-{FIG_TARGET[target_name]}")


def _phi_of(target_name: str, target):
    """The functional of the φ-convergence study on raw draws: eight
    schools min_j θ_j (either parametrization), diamonds the uncentered
    intercept Intercept − mean(X)·b."""
    if target_name == "diamonds":
        from adaptive_mcmc_tpu_torch.models import data as _data

        mx = np.asarray(_data.diamonds()["X"])[:, 1:].mean(axis=0)

        def phi(draws: Tensor) -> Tensor:
            m = torch.as_tensor(mx, dtype=draws.dtype, device=draws.device)
            return draws[..., 0] - draws[..., 1:1 + m.shape[0]] @ m

        return phi

    def min_effect(draws: Tensor) -> Tensor:
        sites = target.constrain(draws)
        if "theta_base" in sites:
            theta = sites["mu"][..., None] \
                + sites["tau"][..., None] * sites["theta_base"]
        else:
            theta = sites["theta"]
        return theta.min(dim=-1).values

    return min_effect


def data_phi_convergence(target_name: str = "eight_schools", runs=None,
                         device="cuda") -> Optional[dict]:
    """Running means of φ over each seed's draws, less φ's gold mean, per
    kernel with a w_eval run: mean and the 50% and 90% bands over the
    seeds."""
    target = TARGETS[target_name]()
    gold = _gold(target_name, runs)
    if gold is None:
        return None
    phi_fn = _phi_of(target_name, target)
    ref_phi = torch.mean(phi_fn(_on(gold, device)))
    out = {}
    for kernel, _ in PHI_COLORS:
        f = _runs(runs) / "w_eval" / target_name / f"{kernel}.npz"
        if not f.exists():
            continue
        with np.load(f) as d:
            phis = phi_fn(_on(d["samples"], device))      # (seeds, draws)
        n = torch.arange(1, phis.shape[1] + 1, device=phis.device)
        cum = torch.cumsum(phis, dim=1) / n - ref_phi
        out.update(_bands(cum, kernel, (0.05, 0.25, 0.75, 0.95)))
    return out or None


def draw_phi_convergence(data: dict, target_name: str,
                         out_dir: Path) -> None:
    plt = _plt()
    for kernel, color in PHI_COLORS:
        if f"{kernel}.mean" not in data:
            continue
        mean = data[f"{kernel}.mean"]
        ns = np.arange(1, mean.shape[0] + 1)
        fig, ax = plt.subplots(figsize=(6.0, 4.0))
        ax.set_title(kernel)
        ax.plot(ns, mean, color=color, label="mean")
        ax.fill_between(ns, data[f"{kernel}.q25"], data[f"{kernel}.q75"],
                        alpha=0.5, color=color, label="50% CI")
        ax.fill_between(ns, data[f"{kernel}.q05"], data[f"{kernel}.q95"],
                        alpha=0.2, color=color, label="90% CI")
        if target_name == "eight_schools":
            ax.set_ylim(-0.5, 0.5)
        ax.set_xlabel(r"number of samples $n$")
        ax.set_ylabel(r"estimator $\widehat{\pi}_n(\varphi)$")
        ax.legend(loc="upper right")
        _save(fig, out_dir,
              f"{PHI_KERNEL[kernel]}-phi-eval-{FIG_TARGET[target_name]}")


# -- the eval CSVs as pandas reads them, and its groupby aggregate ---------

_TENS = [float(f"1e{i}") for i in range(309)]


def parse_float(s: str) -> float:
    """The float ``pd.read_csv`` reads from ``s`` with its default C
    parser (``precise_xstrtod``): up to 17 digits accumulated as
    ``number * 10 + digit`` in double precision, leading zeros counted,
    then one multiplication or division by a power of ten.  It differs
    from ``float(s)`` in the last bit of many values.  "" is NaN."""
    s = s.strip()
    if not s:
        return math.nan
    p, neg = 0, False
    if s[0] in "+-":
        neg, p = s[0] == "-", 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < len(s) and s[p].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < len(s) and s[p] == ".":
        p += 1
        while digits < 17 and p < len(s) and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            p, digits, decimals = p + 1, digits + 1, decimals + 1
        while p < len(s) and s[p].isdigit():
            p += 1
        exponent -= decimals
    if neg:
        number = -number
    if p < len(s) and s[p] in "eE":
        exponent += int(s[p + 1:])
    if exponent > 308:
        return math.copysign(math.inf, number) if number else 0.0
    if exponent > 0:
        return number * _TENS[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _TENS[-308 - exponent] / _TENS[308]
    return number / _TENS[-exponent]


def _group_mean(vals) -> float:
    """pandas' group mean: Kahan-compensated sum over the non-NaN values."""
    total = comp = 0.0
    n = 0
    for v in vals:
        if v != v:
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / n if n else math.nan


def _group_std(vals) -> float:
    """pandas' group std (ddof 1): Welford's recursion over the non-NaN
    values, then the square root."""
    n, mean, m2 = 0, 0.0, 0.0
    for v in vals:
        if v != v:
            continue
        n += 1
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (n - 1)) if n > 1 else math.nan


def _read_eval(path: Path) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {m: np.asarray([parse_float(r[m]) for r in rows])
            for m in ("rng_seed",) + METRICS}


def data_metric_boxplots(target_name: str, runs=None,
                         device="cuda") -> Optional[dict]:
    """Each kernel's per-seed rmse / W / MMD from its eval CSV and their
    mean and std per kernel (the aggregate table)."""
    out = {}
    for kernel in ("arwmh", "asss", "nuts"):
        f = _runs(runs) / "w_eval" / target_name / f"eval_{kernel}.csv"
        if not f.exists():
            continue
        cols = _read_eval(f)
        for m in METRICS:
            out[f"{kernel}.{m}"] = cols[m]
            out[f"{kernel}.{m}.agg"] = np.asarray(
                [_group_mean(cols[m]), _group_std(cols[m])])
    return out or None


def _csv_float(v: float) -> str:
    return "" if v != v else repr(float(v))


def aggregate_csv(data: dict) -> str:
    """The aggregate table in ``DataFrame.to_csv``'s layout of a groupby
    aggregate with (metric, mean/std) columns, kernels in sorted order."""
    kernels = sorted({k.split(".")[0] for k in data if k.endswith(".agg")})
    lines = ["," + ",".join(m for m in METRICS for _ in range(2)),
             "," + ",".join(s for _ in METRICS for s in ("mean", "std")),
             "algorithm" + "," * (2 * len(METRICS))]
    for k in kernels:
        lines.append(k + "," + ",".join(
            _csv_float(v) for m in METRICS for v in data[f"{k}.{m}.agg"]))
    return "\n".join(lines) + "\n"


def draw_metric_boxplots(data: dict, target_name: str,
                         out_dir: Path) -> None:
    plt = _plt()
    kernels = [k for k in ("arwmh", "asss", "nuts")
               if f"{k}.{METRICS[0]}" in data]
    for metric in METRICS:
        fig, ax = plt.subplots(figsize=(5.0, 4.0))
        cols = [data[f"{k}.{metric}"] for k in kernels]
        box = ax.boxplot([c[~np.isnan(c)] for c in cols], whis=(5, 95),
                         patch_artist=True, tick_labels=kernels)
        for patch, color in zip(box["boxes"], BOX_COLORS):
            patch.set_facecolor(color)
        ax.set_xlabel("algorithm")
        ax.set_ylabel(metric)
        name = "rmse" if metric == "rmse_means" else metric
        _save(fig, out_dir, f"{name}-eval-{FIG_TARGET[target_name]}")
    (Path(out_dir) / f"eval-aggregate-{FIG_TARGET[target_name]}.csv") \
        .write_text(aggregate_csv(data))


def data_kidiq_predictive(runs=None, device="cuda",
                          seed=0) -> Optional[dict]:
    """Posterior-predictive kid_score over mom_iq ∈ [70, 140) for mom_hs
    0 and 1, from one seed's draws of the kidiq NUTS cell: mean and 90%
    band, the noise from a generator on ``device``."""
    f = _runs(runs) / "w_eval" / "kidiq" / "nuts.npz"
    if not f.exists():
        return None
    with np.load(f) as d:
        draws = _on(d["samples"][0], device)
    sites = TARGETS["kidiq"]().constrain(draws)
    mom_iq = np.concatenate([np.arange(70, 140)] * 2).astype(np.float32)
    mom_hs = np.concatenate([np.zeros(70), np.ones(70)]).astype(np.float32)
    Xg = _on(np.stack([np.ones_like(mom_iq), mom_hs, mom_iq], axis=1),
             device)
    mu = sites["beta"] @ Xg.T                               # (n, 140)
    g = torch.Generator(draws.device).manual_seed(seed)
    pred = mu + sites["sigma"][:, None] * torch.randn(
        mu.shape, generator=g, device=draws.device)
    return {"mom_iq": mom_iq, "mom_hs": mom_hs,
            "mean": torch.mean(pred, dim=0).cpu().numpy(),
            "q05": _q(pred, 0.05), "q95": _q(pred, 0.95)}


def draw_kidiq_predictive(data: dict, out_dir: Path) -> None:
    plt = _plt()
    mom_iq, mom_hs = data["mom_iq"], data["mom_hs"]
    fig, axes = plt.subplots(1, 2, figsize=(10, 5), sharex=True, sharey=True)
    for ax, hs in zip(axes, (0.0, 1.0)):
        m = mom_hs == hs
        order = np.argsort(mom_iq[m])
        x = mom_iq[m][order]
        ax.plot(x, data["mean"][m][order], color="black", label="prediction")
        ax.fill_between(x, data["q05"][m][order], data["q95"][m][order],
                        alpha=0.3, color="gray", label="90% interval")
        ax.set_xlabel("mom_iq")
        ax.set_title(f"mom_hs = {int(hs)}")
    axes[0].set_ylabel("kid_score")
    axes[0].legend(loc="upper left")
    _save(fig, out_dir, "kidiq-posterior-predictive")


# -- the families, in the JAX package's order ------------------------------

def families() -> list:
    """(tag, data thunk taking (runs, device), draw taking (data,
    out_dir)) of every family, in the order the JAX package's ``main``
    makes them."""
    out = []
    for tname in ("eight_schools", "diamonds", "kidiq"):
        for kernel in ("arwmh", "asss"):
            out.append((
                f"{kernel}-pe-lr-{tname}",
                lambda r, dv, t=tname, k=kernel: data_lr_decay_pe(t, k, r,
                                                                  dv),
                lambda d, o, t=tname, k=kernel: draw_lr_decay_pe(d, t, k, o)))
            out.append((
                f"{kernel}-adaptation-lr-{tname}",
                lambda r, dv, t=tname, k=kernel: data_lr_decay_adaptation(
                    t, k, r, dv),
                lambda d, o, t=tname, k=kernel: draw_lr_decay_adaptation(
                    d, t, k, o)))
        out.append((
            f"metric-boxplots-{tname}",
            lambda r, dv, t=tname: data_metric_boxplots(t, r, dv),
            lambda d, o, t=tname: draw_metric_boxplots(d, t, o)))
    for tname, tag in (("eight_schools", "phi-eight-schools"),
                       ("diamonds", "phi-diamonds")):
        out.append((
            tag, lambda r, dv, t=tname: data_phi_convergence(t, r, dv),
            lambda d, o, t=tname: draw_phi_convergence(d, t, o)))
    out.append(("kidiq-predictive",
                lambda r, dv: data_kidiq_predictive(r, dv),
                draw_kidiq_predictive))
    return out


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_dir: Path, stem: str) -> None:
    import matplotlib.pyplot as plt

    fig.savefig(Path(out_dir) / f"{stem}.svg", bbox_inches="tight")
    plt.close(fig)


def main(out_dir=OUT_DIR, runs=None, device="cuda",
         data_only: bool = False) -> tuple:
    """Every family whose artifacts exist under ``runs``; ``data_only``
    computes the data and draws nothing.  Returns (made, skipped)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    made, skipped = [], []
    for tag, data_fn, draw_fn in families():
        data = data_fn(runs, device)
        if data is None:
            skipped.append(tag)
            continue
        if not data_only:
            draw_fn(data, out)
        made.append(tag)
    print(f"made: {made}")
    if skipped:
        print(f"skipped (missing artifacts): {skipped}")
    return made, skipped


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        description="The artifact figure families of adaptive_mcmc_tpu_torch.")
    p.add_argument("out_dir", nargs="?", default=str(OUT_DIR))
    p.add_argument("--runs", default=None,
                   help=f"the run root (default {OUT_ROOT})")
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-only", action="store_true")
    a = p.parse_args()
    main(a.out_dir, a.runs, a.device, a.data_only)
