"""A plain ARWMH sampler (Andrieu and Thoms 2008, algorithm 4, with the
covariance held by its Cholesky factor), run from the same initial law
and at the same budget as the program, so that the law of its draws can be
held against the program's: the same algorithm gives the same law, while a
wrong accept test, proposal or adaptation gives another.

Per chain, from x ~ Uniform(-2, 2)^d, loc = x, L = I, log λ = 0:

* x' = x + (e^λ L + ε I) z, z ~ N(0, I); a NaN potential counts as +inf;
* accept with probability α = min(1, exp(U(x) − U(x'))), then with
  n = t + 1 (restarted after warmup: t + 1 − warmup) and γ = n^(−2/3):
  loc += γ (x − loc), L = chol((1 − γ) L Lᵀ + γ δ δᵀ) with δ = x − loc
  before the update (the old factor kept where the factorisation fails),
  log λ += γ (α − 0.234);
* after warmup, every ``thinning``-th state is a draw.

The factor is formed and factorised whole (``torch.linalg.cholesky_ex``),
not updated in rank one; the draws come from a torch.Generator of the
reference's own."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import potentials

LR_DECAY = 2.0 / 3.0
TARGET_ACCEPT = 0.234
EPS = 1e-6


def run(config: dict, chains: int, num_warmup: int, num_samples: int,
        thinning: int, seed: int, dtype: str = "float64",
        device="cpu") -> dict:
    """The draws (chains, draws, d) and each chain's mean acceptance over
    the sampling steps, as float64 numpy arrays."""
    dt = getattr(torch, dtype)
    device = torch.device(device)
    d = int(config["dim"])
    fn = potentials.target(config).potential
    g = torch.Generator(device).manual_seed(seed % 2**63)

    def potential(x):
        u = fn(x, config)[0]
        return torch.where(torch.isnan(u), torch.full_like(u, float("inf")),
                           u)

    eye = torch.eye(d, dtype=dt, device=device)
    x = (torch.rand((chains, d), generator=g, device=device,
                    dtype=torch.float64) * 4.0 - 2.0).to(dt)
    u = potential(x)
    loc, L = x.clone(), eye.expand(chains, d, d).clone()
    log_lam = torch.zeros(chains, dtype=dt, device=device)
    mean_acc = torch.zeros(chains, dtype=torch.float64, device=device)
    draws = torch.empty((chains, num_samples // thinning, d), dtype=dt,
                        device=device)
    for t in range(num_warmup + num_samples):
        z = torch.randn((chains, d), generator=g, device=device,
                        dtype=torch.float64).to(dt)
        v = torch.rand((chains,), generator=g, device=device,
                       dtype=torch.float64).to(dt)
        prop = x + torch.einsum("cij,cj->ci",
                                L * torch.exp(log_lam)[:, None, None]
                                + EPS * eye, z)
        u_prop = potential(prop)
        alpha = torch.exp(u - u_prop).clamp_max(1.0)
        take = v < alpha
        x = torch.where(take[:, None], prop, x)
        u = torch.where(take, u_prop, u)
        n = t + 1 if t < num_warmup else t + 1 - num_warmup
        gamma = float(n) ** -LR_DECAY
        delta = x - loc
        loc = loc + gamma * delta
        cov = (1.0 - gamma) * L @ L.transpose(1, 2) \
            + gamma * delta[:, :, None] * delta[:, None, :]
        # below float32 the factorisation runs in float32 (no kernel
        # factorises bfloat16), its factor rounded back
        new, info = torch.linalg.cholesky_ex(
            cov if dt.itemsize >= 4 else cov.float())
        new = new.to(dt)
        L = torch.where((info == 0)[:, None, None], new, L)
        log_lam = log_lam + gamma * (alpha - TARGET_ACCEPT)
        if t >= num_warmup:
            k = t - num_warmup + 1
            mean_acc += (alpha.to(torch.float64) - mean_acc) / k
            if k % thinning == 0:
                draws[:, k // thinning - 1] = x
    return {"x": draws.to(torch.float64).cpu().numpy(),
            "map": mean_acc.cpu().numpy()}


# the statistics of each coordinate's pooled draws that are compared
QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


def law_gap(x: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap between the two samples' pooled per-coordinate mean,
    sd and quantiles, in the reference's sd of that coordinate."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    ref = np.asarray(ref, np.float64).reshape(-1, ref.shape[-1])
    sd = ref.std(axis=0)
    stats = [lambda a: a.mean(axis=0), lambda a: a.std(axis=0)] + [
        (lambda q: lambda a: np.quantile(a, q, axis=0))(q)
        for q in QUANTILES]
    gap = max(float(np.max(np.abs(s(x) - s(ref)) / sd)) for s in stats)
    return gap if np.isfinite(gap) else float("inf")
