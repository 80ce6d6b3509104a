#!/usr/bin/env python3
"""Size the ARWMH-on-diamonds run of chip_smoke.py on the JAX package (CPU).

    python scripts/size_arwmh_diamonds.py [--chains 64] [--samples 50000]
        [--thinning 10] [--warmup 200000 500000 1000000] [--seed 0]

For each warmup length, runs the JAX package's ARWMH (lockstep, jitted) on
diamonds (sufficient-statistic form, d = 26) from its default uniform
initialisation, then grades the pooled draws against the PosteriorDB gold
draws with chip_smoke.py's bands: max_k |mean_k - gold_k| / gold_sd_k
<= 0.3 and every sd ratio in [0.7, 1.4].  Prints one line per length.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402

import adaptive_mcmc_tpu as amt  # noqa: E402
from adaptive_mcmc_tpu.models import data as jdata  # noqa: E402

MAX_MEAN_ERR, SD_RATIO = 0.3, (0.7, 1.4)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--samples", type=int, default=50000)
    ap.add_argument("--thinning", type=int, default=10)
    ap.add_argument("--warmup", type=int, nargs="+",
                    default=[200000, 500000, 1000000])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    gold = np.load(os.path.join(os.path.dirname(jdata.__file__), "_gold",
                                "diamonds.npy")).astype(np.float64)
    gm, gsd = gold.mean(0), gold.std(0)
    target = amt.diamonds()
    for warmup in args.warmup:
        kernel = amt.arwmh(target, amt.ARWMHConfig(num_warmup=warmup))
        t0 = time.perf_counter()
        samples, _, last = amt.run_mcmc(
            kernel, jax.random.PRNGKey(args.seed), warmup, args.samples,
            thinning=args.thinning, n_chains=args.chains)
        x = np.asarray(samples, np.float64)                 # (T, C, d)
        wall = time.perf_counter() - t0
        flat = x.reshape(-1, x.shape[-1])
        err = np.abs(flat.mean(0) - gm) / gsd
        ratio = flat.std(0) / gsd
        ok = (err.max() <= MAX_MEAN_ERR and SD_RATIO[0] <= ratio.min()
              and ratio.max() <= SD_RATIO[1])
        accept = float(np.mean(np.asarray(last.mean_accept_prob)))
        print(f"warmup {warmup} + {args.samples} (thinning "
              f"{args.thinning}, {args.chains} chains, seed {args.seed}): "
              f"max standardized mean error {err.max():.4f} (coordinate "
              f"{int(err.argmax())}), sd ratio [{ratio.min():.4f}, "
              f"{ratio.max():.4f}], mean acceptance {accept:.4f}, "
              f"{'holds' if ok else 'misses'} the bands; {wall:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
