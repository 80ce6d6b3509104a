"""ASSS reference runs of kidiq, the port's against the JAX package's at
the same settings, on the CPU.

A reference run (``make_reference_draws``) warms up, then keeps a short
window of thinned draws per chain while the adaptation clock restarts
(``adaptation_lr``: γ = 1 on the first step after warmup).  At the sweep's
settings (``evaluate.REFERENCE_RUN``: 256 chains, 3000 warmup, thinning
10, 40 draws a chain) ASSS's pooled draws come out some 5% wider than the
quadrature truth in both packages, and at 2000 warmup a few chains are
still far out.  The test holds the port's run to JAX's at a small size;
run as a script, it prints the table at the full settings:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_asss_reference.py \\
        [--seeds 999,1000] [--warmups 3000,2000] [--chains 256]

one row per (package, seed, warmup): max |mean err| / truth sd, the sd
ratio range (``moments_parity.kidiq_parity``) and the chains with a draw
more than 5 truth sd from the truth's mean.
"""

import argparse
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from adaptive_mcmc_tpu_torch.experiments.moments_parity import (  # noqa: E402,E501
    kidiq_parity,
)
from adaptive_mcmc_tpu_torch.experiments.quadrature import kidiq_truth  # noqa: E402,E501

FAR_SD = 5.0


def asss_reference(package: str, seed: int, n_chains: int, num_warmup: int,
                   thinning: int = 10, per_chain: int = 40) -> np.ndarray:
    """make_reference_draws' run of ASSS on kidiq in either package:
    (chains, per_chain, 4) draws."""
    if package == "jax":
        import adaptive_mcmc_tpu as amt
        from adaptive_mcmc_tpu.infer.mcmc import run_mcmc
        key = jax.random.PRNGKey(seed)
    else:
        import adaptive_mcmc_tpu_torch as amt
        from adaptive_mcmc_tpu_torch.infer.mcmc import run_mcmc
        key = torch.Generator().manual_seed(seed)
    kernel = amt.asss(amt.kidiq(), amt.ASSSConfig(lr_decay=2.0 / 3.0,
                                                  num_warmup=num_warmup))
    samples, _, _ = run_mcmc(kernel, key, num_warmup=num_warmup,
                             num_samples=per_chain * thinning,
                             thinning=thinning, n_chains=n_chains)
    return np.swapaxes(np.asarray(samples), 0, 1)


def row(draws: np.ndarray) -> dict:
    tr = kidiq_truth()
    mean = np.concatenate([tr["mean_beta"], [tr["mean_log_sigma"]]])
    sd = np.concatenate([tr["sd_beta"], [tr["sd_log_sigma"]]])
    far = np.abs((draws - mean) / sd).max(-1) > FAR_SD
    return {**kidiq_parity(draws.reshape(-1, 4)),
            "far_chains": int(far.any(-1).sum())}


def jackknife(draws: np.ndarray, stat) -> tuple:
    """``stat`` of the pooled (chains, n, d) draws and its standard error by
    the jackknife over chains (the chains are independent, their draws
    are not)."""
    C = draws.shape[0]
    full = stat(draws.reshape(-1, draws.shape[-1]))
    loo = np.stack([stat(np.delete(draws, c, 0).reshape(-1, draws.shape[-1]))
                    for c in range(C)])
    return full, np.sqrt((C - 1) / C * ((loo - loo.mean(0)) ** 2).sum(0))


def test_port_asss_reference_matches_jax():
    """32 chains at the sweep's warmup, thinning and draws per chain, seed
    999: each coordinate's pooled mean and sd within 4 standard errors of
    the difference of JAX's (jackknife over chains), and no chain far out
    in either."""
    torch.set_num_threads(1)
    got = asss_reference("port", 999, 32, 3000)
    want = asss_reference("jax", 999, 32, 3000)
    assert got.shape == want.shape == (32, 40, 4)
    assert np.isfinite(got).all()
    for stat in (lambda x: x.mean(0), lambda x: x.std(0)):
        g, se_g = jackknife(got, stat)
        w, se_w = jackknife(want, stat)
        z = np.abs(g - w) / np.sqrt(se_g ** 2 + se_w ** 2)
        assert z.max() <= 4.0, (g, w, z)
    assert row(got)["far_chains"] == row(want)["far_chains"] == 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="999,1000")
    ap.add_argument("--warmups", default="3000,2000")
    ap.add_argument("--chains", type=int, default=256)
    args = ap.parse_args(argv)
    print(f"| package | seed | warmup | chains x draws | max |mean err| / "
          f"truth sd | sd ratio range | chains > {FAR_SD:g} sd |")
    print("|---|---|---|---|---|---|---|")
    for w in (int(s) for s in args.warmups.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            for package in ("jax", "port"):
                r = row(asss_reference(package, seed, args.chains, w))
                print(f"| {package} | {seed} | {w} | {args.chains} x 40 | "
                      f"{r['max_mean_err_sd']:.4f} | [{r['sd_ratio_min']:.4f}"
                      f", {r['sd_ratio_max']:.4f}] | {r['far_chains']} |",
                      flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    main()
