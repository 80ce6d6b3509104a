"""The w_eval sweep on the card: every (target, kernel) cell run for all
seeds (``run_w_eval``), then graded (``evaluate_run``), with a results
state file of one row per cell.  The port's counterpart of
``scripts/run_full_sweeps.py``.

    python -m adaptive_mcmc_tpu_torch.experiments.sweep \\
        --state mcmc_runs/torch_h100/results_state.json \\
        [--scale diamonds/arwmh=0.1,diamonds/asss=0.05] [--targets ...] \\
        [--fused arwmh,asss]

Budgets are ``W_EVAL_BUDGETS`` cut by the CLI's ``--scale`` per cell (1
by default); NUTS fans out 16 clones per chain after warmup where the
draw count divides (``FAN_OUT``, as ``scripts/run_full_sweeps.py``).
``--fused`` names the kernels (``arwmh``, ``asss``) or cells
(``diamonds/arwmh``) that run through K2 / K3 (``runner.build_kernel``);
the others take their default drivers.  The gold standard is the vendored
PosteriorDB draws where there are some (diamonds), else a long NUTS run of
the port (``evaluate.REFERENCE_RUN``: 256 chains, 3000 warmup, thinning
10, seed 999, the JAX sweep's settings; cached in ``reference_draws/``
beside the state file;
``--ref-kernel`` picks another sampler for it).  The exact W covers the first ``--exact-w-seeds`` seeds
(all by default) by the batched ε-auction (8 seeds per batch,
warm-started), checked against the host Hungarian on seed 8, the first
warm-started one.

A row holds the scale, fan-out, driver stamp and reference, wall and chain-iters/s
of the run, rmse / W / MMD mean and std over seeds (std with ddof 1),
``ess_med`` (median over seeds of each seed's median-dim ESS),
``ess_per_sec`` (the seeds' median-dim ESS summed, over the run's wall),
the seconds of each metric column, and the card's name and power limit.
A cell already in the state file is skipped, so a cut sweep resumes.
The npz files go under ``--out-dir``; the per-seed CSVs beside the state
file.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from adaptive_mcmc_tpu_torch.bench import card_name
from adaptive_mcmc_tpu_torch.experiments.cli import _scaled_budget
from adaptive_mcmc_tpu_torch.experiments.configs import OUT_ROOT, RunConfig
from adaptive_mcmc_tpu_torch.experiments.evaluate import (
    REFERENCE_RUN,
    evaluate_run,
    get_reference_draws,
)
from adaptive_mcmc_tpu_torch.experiments.runner import run_device, run_w_eval

KERNEL_ORDER = ("arwmh", "asss", "nuts", "sa")
TARGET_ORDER = ("eight_schools", "kidiq", "diamonds")
FAN_OUT = {"nuts": 16}
EXACT_W_BATCH = 8


def cell_config(target: str, kernel: str, scale: float, seeds: int,
                out_dir: str, fused=None) -> RunConfig:
    budget = _scaled_budget(target, kernel, scale)
    fan = FAN_OUT.get(kernel, 1)
    if (budget["num_samples"] // budget["thinning"]) % fan:
        fan = 1
    return RunConfig(target=target, kernel=kernel, n_seeds=seeds,
                     out_dir=out_dir, fan_out=fan, fused=fused, **budget)


def add_fused_arg(ap: argparse.ArgumentParser) -> None:
    """``--fused``: the kernels (``arwmh``, ``asss``) or cells
    (``diamonds/arwmh``) that run through K2 / K3, comma-separated, as a
    set; none by default (every cell on its default driver, as the JAX
    sweeps).  The sweep's and lr_sweep's one parser."""
    ap.add_argument("--fused", default=frozenset(),
                    type=lambda s: frozenset(filter(None, s.split(","))),
                    help="kernels or cells run through K2/K3, e.g. "
                         "arwmh,asss or diamonds/arwmh; none by default")


def is_fused(fused: set, target: str, kernel: str):
    """True where ``--fused`` names the kernel or the cell, else None (the
    kernel's default driver)."""
    return True if {kernel, f"{target}/{kernel}"} & fused else None


def metric_stats(table) -> dict:
    """rmse / W / MMD mean and std over the seeds that have the metric
    (the exact W may cover the first seeds only), std with ddof 1: the
    pandas ``mean`` / ``std`` of the JAX sweep."""
    out = {}
    for short, col in (("rmse", "rmse_means"), ("w", "wasserstein"),
                       ("mmd", "mmd")):
        v = np.asarray(table[col], np.float64)
        v = v[~np.isnan(v)]
        out[f"{short}_mean"] = float(v.mean())
        out[f"{short}_std"] = float(v.std(ddof=1))
    return out


def run_cell(target: str, kernel: str, scale: float, *, seeds: int,
             out_dir: str, csv_dir: Path, exact_w_seeds: int, card: str,
             ref_kernel: str = "nuts", fused=None, device=None) -> dict:
    cfg = cell_config(target, kernel, scale, seeds, out_dir, fused)
    npz = run_w_eval(cfg, device=device)
    with np.load(npz, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
    ref = get_reference_draws(
        target, kernel_name=ref_kernel, **REFERENCE_RUN,
        cache_dir=str(csv_dir / "reference_draws"), device=device)
    timings: dict = {}
    t0 = time.perf_counter()
    table = evaluate_run(
        npz, ref, csv_dir / target / f"eval_{kernel}.csv",
        exact_wasserstein_seeds=exact_w_seeds, exact_w_batch=EXACT_W_BATCH,
        hungarian_check_seeds=0, sinkhorn=False, verbose=True,
        device=device, timings=timings)
    ess = np.asarray(table["ess_median"], np.float64)
    return {
        "scale": scale, "fan_out": cfg.fan_out, "n_seeds": seeds,
        "num_warmup": cfg.num_warmup, "num_samples": cfg.num_samples,
        "thinning": cfg.thinning, "driver": meta["driver"],
        "wall": meta["wall_seconds"], "rate": meta["chain_iters_per_sec"],
        **metric_stats(table),
        "ess_med": float(np.median(ess)),
        "ess_min": float(np.min(np.asarray(table["ess_min"]))),
        "ess_per_sec": float(ess.sum() / meta["wall_seconds"]),
        "exact_w_seeds": min(seeds, exact_w_seeds),
        "reference": "gold" if target == "diamonds" else ref_kernel,
        "eval_seconds": time.perf_counter() - t0,
        "metric_seconds": timings, "card": card,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="adaptive_mcmc_tpu_torch.experiments"
                                 ".sweep")
    ap.add_argument("--targets", default=",".join(TARGET_ORDER))
    ap.add_argument("--kernels", default=",".join(KERNEL_ORDER))
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--scale", default="",
                    help="per-cell scales, target/kernel=s,...; others 1")
    ap.add_argument("--out-dir", default=OUT_ROOT,
                    help="npz files and manifests")
    ap.add_argument("--state", default="mcmc_runs/torch_h100/"
                    "results_state.json")
    ap.add_argument("--exact-w-seeds", type=int, default=100)
    ap.add_argument("--ref-kernel", default="nuts",
                    help="kernel of the reference run where no gold draws "
                         "are vendored (eight schools, kidiq)")
    add_fused_arg(ap)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from adaptive_mcmc_tpu_torch.experiments.configs import W_EVAL_BUDGETS

    scales = {}
    for item in filter(None, args.scale.split(",")):
        cell, _, s = item.partition("=")
        scales[cell] = float(s)
    state_path = Path(args.state)
    state = json.loads(state_path.read_text()) if state_path.exists() \
        else {}
    card = card_name() if run_device(args.device).type == "cuda" else "cpu"
    print(f"[sweep] {card}", flush=True)
    for target in args.targets.split(","):
        for kernel in args.kernels.split(","):
            if (target, kernel) not in W_EVAL_BUDGETS:
                continue
            key = f"{target}|{kernel}"
            if key in state:
                print(f"[skip] {key} already evaluated")
                continue
            t0 = time.perf_counter()
            row = run_cell(target, kernel, scales.get(f"{target}/{kernel}",
                                                      1.0),
                           seeds=args.seeds, out_dir=args.out_dir,
                           csv_dir=state_path.parent,
                           exact_w_seeds=args.exact_w_seeds, card=card,
                           ref_kernel=args.ref_kernel,
                           fused=is_fused(args.fused, target, kernel),
                           device=args.device)
            state[key] = row
            state_path.parent.mkdir(parents=True, exist_ok=True)
            state_path.write_text(json.dumps(state, indent=1) + "\n")
            print(f"[cell] {key}: " + json.dumps(row), flush=True)
            print(f"[cell] {key}: {time.perf_counter() - t0:.1f} s in all",
                  flush=True)


if __name__ == "__main__":
    main()
