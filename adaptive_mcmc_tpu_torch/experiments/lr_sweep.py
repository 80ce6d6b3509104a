"""The lr_decay family on the card: {eight_schools_centered, diamonds,
kidiq} × {arwmh, asss} × ``LR_DECAYS``, each decay one batched run of
``--seeds`` chains over 10^n_pow steps (``runner.run_lr_decay``).  The
port's counterpart of ``scripts/run_lr_decay_sweeps.py``.

    python -m adaptive_mcmc_tpu_torch.experiments.lr_sweep \\
        [--targets ...] [--kernels arwmh,asss] [--n-pow 6] [--seeds 100] \\
        [--fused arwmh,asss] [--out-dir mcmc_runs/torch] \\
        [--summaries mcmc_runs/torch_h100/lr_decay]

``--fused`` names the kernels or cells (``diamonds/asss``) that run
through K2 / K3, as on the sweep (``sweep.add_fused_arg``; none by
default).  The family is run with ``--fused arwmh,asss``: at 100 chains a
lockstep ARWMH step or an iteration of the ASSS machine costs its
launches, 10^6 of them a decay.  The trajectory
npz files (large) stay under ``--out-dir``; each cell's summary CSVs
(``experiments/summaries.py``, stamped with the driver) are copied to
``--summaries/<target>/<kernel>/``, where the committed ones live.  A
cell prints its wall and chain-iters/s per decay, and the median over the
seeds of ``as_change`` over the last decade (the tail that the lr_decay
claims order across decays).
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from adaptive_mcmc_tpu_torch.experiments.configs import LR_DECAYS, OUT_ROOT
from adaptive_mcmc_tpu_torch.experiments.runner import run_lr_decay
from adaptive_mcmc_tpu_torch.experiments.summaries import (
    read_lr_decay_summary,
    summary_path_for,
)
from adaptive_mcmc_tpu_torch.experiments.sweep import add_fused_arg, is_fused

LR_TARGETS = ("eight_schools_centered", "diamonds", "kidiq")
LR_KERNELS = ("arwmh", "asss")


def tail(summary) -> float:
    """The median over the last decade of the seeds' median as_change."""
    _, cols = read_lr_decay_summary(summary)
    i = cols["i"]
    return float(np.median(cols["as_change_q50"][i > i[-1] / 10]))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="adaptive_mcmc_tpu_torch.experiments.lr_sweep")
    ap.add_argument("--targets", default=",".join(LR_TARGETS))
    ap.add_argument("--kernels", default=",".join(LR_KERNELS))
    ap.add_argument("--n-pow", type=int, default=6)
    ap.add_argument("--seeds", type=int, default=100)
    add_fused_arg(ap)
    ap.add_argument("--out-dir", default=OUT_ROOT,
                    help="trajectory npz files, manifests, summaries")
    ap.add_argument("--summaries", default="mcmc_runs/torch_h100/lr_decay",
                    help="where each cell's summary CSVs are copied")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    for target in args.targets.split(","):
        for kernel in args.kernels.split(","):
            paths = run_lr_decay(
                target, kernel, n_pow=args.n_pow, n_seeds=args.seeds,
                out_dir=args.out_dir, device=args.device,
                fused=is_fused(args.fused, target, kernel))
            dest = Path(args.summaries) / target / kernel
            dest.mkdir(parents=True, exist_ok=True)
            for npz in paths:
                summary = summary_path_for(npz)
                shutil.copy2(summary, dest / summary.name)
                meta, _ = read_lr_decay_summary(summary)
                wall = float(meta.get("wall_seconds", "nan"))
                rate = args.seeds * 10 ** args.n_pow / wall
                print(f"[lr_decay] {target}/{kernel} decay "
                      f"{meta['lr_decay']}: {meta.get('driver', 'default')}"
                      f", {wall:.2f} s, {rate:.1f} chain-iters/s, "
                      f"as_change tail {tail(summary):.6g}", flush=True)


if __name__ == "__main__":
    main()
