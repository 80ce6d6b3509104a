"""Wasserstein-algorithm benchmark (PyTorch; the reference's
compare_wasserstein.py).

Times the metric algorithms over n x d subsets of two sample sets and
writes a CSV: exact 1-1 coupling (native Hungarian / SciPy), the
ε-auction on the device, Sinkhorn at several epsilons, max-sliced with
100/10k directions, moment RMSE, and MMD — the table of
``adaptive_mcmc_tpu.experiments.compare_wasserstein`` on the port's
metrics, the CSV written with the ``csv`` module.  Runs on the card unless
``device="cpu"`` is passed.

Run: python -m adaptive_mcmc_tpu_torch.experiments.compare_wasserstein
[out.csv] [--device cpu]
"""

from __future__ import annotations

import csv
import sys
import time

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.experiments.runner import (
    run_device,
    synchronize,
)
from adaptive_mcmc_tpu_torch.metrics import (
    max_sliced_wasserstein,
    mmd_heuristic,
    pth_moment_rmse,
    wasserstein_dist11_p,
    wasserstein_sinkhorn,
)

FIELDS = ("algorithm", "n", "d", "seconds", "value")


def _example_clouds(n: int, d: int, device, seed: int = 0):
    """Synthetic stand-in for the reference's checked-in diamonds sample
    pickles: two correlated Gaussian clouds with a mean offset."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)) * 0.3 + np.eye(d)
    x = rng.standard_normal((n, d)) @ mix
    y = rng.standard_normal((n, d)) @ mix + 0.1
    return (torch.as_tensor(x, dtype=torch.float32, device=device),
            torch.as_tensor(y, dtype=torch.float32, device=device))


def _timed(fn, device):
    fn()  # warm-up: builds, first launches
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return time.perf_counter() - t0, out


def run(ns=(30, 100, 300, 1000, 3000), ds=(5, 10, 25), out_csv=None,
        device=None):
    dev = run_device(device)
    rows = []
    for d in ds:
        for n in ns:
            x, y = _example_clouds(n, d, dev)

            def sliced(k):
                g = torch.Generator(dev).manual_seed(0)
                return max_sliced_wasserstein(x, y, g, n_directions=k)

            algos = {
                "hungarian": lambda: wasserstein_dist11_p(x, y),
                "auction": lambda: wasserstein_dist11_p(x, y,
                                                        solver="auction"),
                "sinkhorn_default": lambda: wasserstein_sinkhorn(x, y),
                "sinkhorn_eps1e-2": lambda: wasserstein_sinkhorn(
                    x, y, epsilon=1e-2
                ),
                "sinkhorn_eps1e-3": lambda: wasserstein_sinkhorn(
                    x, y, epsilon=1e-3, max_iters=5000
                ),
                "max_sliced_100": lambda: sliced(100),
                "max_sliced_10000": lambda: sliced(10_000),
                "moment_rmse": lambda: pth_moment_rmse(x, y),
                "mmd_heuristic": lambda: mmd_heuristic(x, y),
            }
            for name, fn in algos.items():
                dt, val = _timed(fn, dev)
                rows.append({"algorithm": name, "n": n, "d": d,
                             "seconds": dt, "value": float(val)})
                print(
                    f"{name:>18} n={n:<5} d={d:<3} "
                    f"{dt*1e3:9.1f} ms  value={float(val):.4f}",
                    flush=True,
                )
    if out_csv:
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(FIELDS)
            for r in rows:
                w.writerow([r["algorithm"], r["n"], r["d"],
                            repr(r["seconds"]), repr(r["value"])])
        print(f"written {out_csv}")
    return rows


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    run(out_csv=args[0] if args else None, device=dev)
