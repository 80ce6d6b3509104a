"""How far a w_eval cell's grade moves with its gold set: the cell's run
graded against several independent reference runs of the port, each made
as the sweep makes its own (``evaluate.REFERENCE_RUN``: a long NUTS run of
256 chains, 3000 warmup, thinning 10), one ``rng_seed`` each; per reference, rmse, W and MMD mean
and std over seeds (std with ddof 1), then each metric's spread over the
references.

    python -m adaptive_mcmc_tpu_torch.experiments.gold_spread \\
        --target eight_schools --kernels arwmh,nuts --ref-seeds 999,1000 \\
        [--scale 1] [--out-dir mcmc_runs/torch] [--exact-w-seeds 8] \\
        [--device cpu]

Each cell runs as the sweep runs it (``sweep.cell_config``: 100 seeds,
NUTS fanned out 16 ways; skipped where its npz is done); the reference of
seed 999 is the sweep's own.  Each reference is cached under
``<out-dir>/reference_draws/seed_<seed>/``.  The exact W covers the first
``--exact-w-seeds`` seeds (one batch of 8 by default).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from adaptive_mcmc_tpu_torch.experiments.configs import OUT_ROOT
from adaptive_mcmc_tpu_torch.experiments.evaluate import (
    REFERENCE_RUN,
    evaluate_run,
    make_reference_draws,
)
from adaptive_mcmc_tpu_torch.experiments.runner import run_w_eval
from adaptive_mcmc_tpu_torch.experiments.sweep import (
    EXACT_W_BATCH,
    cell_config,
    metric_stats,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="adaptive_mcmc_tpu_torch.experiments.gold_spread")
    ap.add_argument("--target", required=True)
    ap.add_argument("--kernels", required=True)
    ap.add_argument("--ref-seeds", default="999,1000")
    ap.add_argument("--ref-kernel", default="nuts")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--out-dir", default=OUT_ROOT)
    ap.add_argument("--exact-w-seeds", type=int, default=EXACT_W_BATCH)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    refs = {}
    for seed in (int(s) for s in args.ref_seeds.split(",")):
        refs[seed] = make_reference_draws(
            args.target, kernel_name=args.ref_kernel,
            **{**REFERENCE_RUN, "rng_seed": seed},
            cache_dir=str(Path(args.out_dir) / "reference_draws"
                          / f"seed_{seed}"),
            device=args.device)
    out = {}
    for kernel in args.kernels.split(","):
        cell = f"{args.target}|{kernel}"
        npz = run_w_eval(cell_config(args.target, kernel, args.scale,
                                     args.seeds, args.out_dir),
                         verbose=False, device=args.device)
        rows = {}
        for seed, ref in refs.items():
            rows[seed] = metric_stats(evaluate_run(
                npz, ref, exact_wasserstein_seeds=args.exact_w_seeds,
                exact_w_batch=EXACT_W_BATCH, hungarian_check_seeds=0,
                sinkhorn=False, device=args.device))
            print(json.dumps({"cell": cell, "scale": args.scale,
                              "ref_seed": seed, **rows[seed]}), flush=True)
        spread = {m: max(r[f"{m}_mean"] for r in rows.values())
                  - min(r[f"{m}_mean"] for r in rows.values())
                  for m in ("rmse", "w", "mmd")}
        print(json.dumps({"cell": cell, "spread_of_means": spread}),
              flush=True)
        out[cell] = {"rows": rows, "spread": spread}
    return out


if __name__ == "__main__":
    main()
