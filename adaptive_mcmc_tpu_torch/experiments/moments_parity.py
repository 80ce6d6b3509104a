"""Kidiq's draws against the quadrature truth, a yardstick independent of
any sampler (:func:`quadrature.kidiq_truth`: OLS beta, 1-D quadrature of
log sigma).

For a set of draws in kidiq's comparison space [beta(3), log_sigma] it
gives the largest |mean error| over the truth's sd and the range of the
sd ratios (draws' sd, ddof 0, over the truth's): the moments-parity table
of the JAX sweep (``scripts/run_full_sweeps.py``), there for the pooled
cells only, here for the reference runs as well.

    python -m adaptive_mcmc_tpu_torch.experiments.moments_parity \\
        --refs nuts,asss --ref-dir mcmc_runs/torch_h100/reference_draws \\
        [--runs <out-dir>/w_eval/kidiq] [--out parity.json]

``--refs`` loads each reference run from ``--ref-dir``
(``kidiq_<kernel>.npy``) or builds it there with the sweep's settings
(``make_reference_draws`` at ``evaluate.REFERENCE_RUN``: 256 chains, 3000
warmup, thinning 10, seed 999, 10000 draws; on the card unless ``--device
cpu``); ``--n-chains``, ``--num-warmup``,
``--thinning`` and ``--rng-seed`` build them with other settings instead
(in a ``--ref-dir`` of their own: a cache of other settings raises);
``--draws`` checks .npy files of draws as they are.  ``--runs`` pools every
seed of each ``<kernel>.npz`` of a w_eval directory.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from adaptive_mcmc_tpu_torch.experiments.quadrature import kidiq_truth


def kidiq_parity(draws: np.ndarray) -> dict:
    """(n, 4) draws -> max |mean err| / truth sd, the sd ratios' range and
    the draw count."""
    tr = kidiq_truth()
    t_mean = np.concatenate([tr["mean_beta"], [tr["mean_log_sigma"]]])
    t_sd = np.concatenate([tr["sd_beta"], [tr["sd_log_sigma"]]])
    s = np.asarray(draws, np.float64).reshape(-1, t_mean.size)
    ratio = s.std(axis=0) / t_sd
    return {
        "max_mean_err_sd": float(np.max(np.abs(s.mean(axis=0) - t_mean)
                                        / t_sd)),
        "sd_ratio_min": float(ratio.min()),
        "sd_ratio_max": float(ratio.max()),
        "n_draws": int(s.shape[0]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="adaptive_mcmc_tpu_torch.experiments.moments_parity")
    ap.add_argument("--refs", default="nuts",
                    help="kernels of the reference runs, e.g. nuts,asss")
    ap.add_argument("--ref-dir",
                    default="mcmc_runs/torch_h100/reference_draws")
    ap.add_argument("--runs", default=None,
                    help="a w_eval directory of kidiq cells (<kernel>.npz)")
    ap.add_argument("--out", default=None, help="the rows as JSON")
    for key in ("n_chains", "num_warmup", "thinning", "rng_seed"):
        ap.add_argument("--" + key.replace("_", "-"), type=int,
                        default=None, help=f"the reference runs' {key} "
                        f"(REFERENCE_RUN's by default)")
    ap.add_argument("--draws", default="",
                    help="comma-separated .npy files of (n, 4) kidiq draws "
                         "to check as they are, e.g. another package's "
                         "reference run")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from adaptive_mcmc_tpu_torch.experiments.evaluate import (
        REFERENCE_RUN,
        make_reference_draws,
    )

    run = dict(REFERENCE_RUN)
    for key in ("n_chains", "num_warmup", "thinning", "rng_seed"):
        if getattr(args, key) is not None:
            run[key] = getattr(args, key)
    rows = {}
    for k in filter(None, args.refs.split(",")):
        ref = make_reference_draws(
            "kidiq", kernel_name=k, **run,
            cache_dir=args.ref_dir, device=args.device)
        rows[f"reference/{k}"] = kidiq_parity(ref)
    for f in filter(None, args.draws.split(",")):
        rows[f"draws/{Path(f).name}"] = kidiq_parity(np.load(f))
    if args.runs is not None:
        for npz in sorted(Path(args.runs).glob("*.npz")):
            with np.load(npz, allow_pickle=False) as d:
                rows[f"pooled/{npz.stem}"] = kidiq_parity(d["samples"])
    print("| draws | n | max |mean err| / truth sd | sd ratio range |")
    print("|---|---|---|---|")
    for name, r in rows.items():
        print(f"| {name} | {r['n_draws']} | {r['max_mean_err_sd']:.4f} | "
              f"[{r['sd_ratio_min']:.4f}, {r['sd_ratio_max']:.4f}] |")
    if args.out is not None:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
    return rows


if __name__ == "__main__":
    main()
