"""kidiq (PosteriorDB ``kidiq-kidscore_momhsiq``): x = [beta(3), log
sigma]; beta flat, sigma ~ half Cauchy(0, 2.5), kid_score ~ N(beta_1 +
beta_2 mom_hs + beta_3 mom_iq, sigma), plus the Jacobian log sigma.  The
data are the configuration's ``data`` file: kid_score, mom_hs and mom_iq,
N rows.

The residual sum goes through the float64 data's exact statistics: with
X = [1, mom_hs, mom_iq], A = XᵀX, b̂ = A⁻¹Xᵀy and SSE_min = Σ (y − X b̂)²,

    Σ (y − Xβ)² = SSE_min + (β − b̂)ᵀ A (β − b̂),

so an evaluation costs the same at any N (a run's check evaluates tens of
millions of draws).

The gold (``gold``) draws exactly from this posterior.  With β flat,

    p(β, σ | y) ∝ HC(σ; 2.5) σ^(−N) exp(−SSE(β) / 2σ²),

and the Gaussian integral over β gives (2π)^(3/2) σ³ |A|^(−1/2), so the
marginal of s = log σ (its Jacobian eˢ included) is

    p(s | y) ∝ HC(eˢ; 2.5) eˢ e^(−(N−3)s) exp(−SSE_min e^(−2s) / 2),

and β | σ, y ~ N(b̂, σ² A⁻¹).  s is drawn by inverse CDF: the density on
``GRID_POINTS`` nodes over ± ``GRID_SD`` of its normal approximation's sd
1 / √(2(N−3)), the CDF by the trapezoid rule, a uniform mapped through it
by linear interpolation; then β = b̂ + σ L⁻ᵀ z with A = L Lᵀ, z ~ N(0,
I₃).  The small linear algebra is written out, free of BLAS and LAPACK,
whose order of sums differs between machines.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.potentials import DATA, LOG_2PI, const, total

COLUMNS = ("kid_score", "mom_hs", "mom_iq")
# log(2 / (pi 2.5)), the half-Cauchy(2.5)'s normalising constant
LOG_HALF_CAUCHY = math.log(2.0 / (math.pi * 2.5))
GRID_SD = 20.0
GRID_POINTS = 200001


def columns(config: dict) -> dict:
    """The configuration's data file as float64 columns."""
    s = np.load(Path(config.get("data_dir", DATA)) / config["data"])
    return {k: np.asarray(s[k], np.float64) for k in COLUMNS}


def cholesky(A: np.ndarray) -> np.ndarray:
    """The lower Cholesky factor of a small symmetric positive definite
    matrix, in Python floats."""
    n = len(A)
    L = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1):
            s = float(A[i, j]) - sum(L[i, k] * L[j, k] for k in range(j))
            L[i, j] = math.sqrt(s) if i == j else s / L[j, j]
    return L


def statistics(cols: dict) -> tuple:
    """(A, b̂, SSE_min) of the float64 columns: sums of products, b̂
    through the Cholesky factor of A."""
    X = [np.ones_like(cols["mom_hs"]), cols["mom_hs"], cols["mom_iq"]]
    y = cols["kid_score"]
    A = np.array([[np.sum(a * b) for b in X] for a in X])
    c = [float(np.sum(a * y)) for a in X]
    L = cholesky(A)
    w = []
    for i in range(3):                      # L w = c
        w.append((c[i] - sum(L[i, k] * w[k] for k in range(i))) / L[i, i])
    b_hat = [0.0] * 3
    for i in reversed(range(3)):            # Lᵀ b̂ = w
        b_hat[i] = (w[i] - sum(L[k, i] * b_hat[k]
                               for k in range(i + 1, 3))) / L[i, i]
    r = y - (b_hat[0] * X[0] + b_hat[1] * X[1] + b_hat[2] * X[2])
    return A, np.array(b_hat), float(np.sum(r * r))


def raw(config: dict) -> dict:
    """The statistics of the configuration's data as float64 arrays."""
    cols = columns(config)
    A, b_hat, sse_min = statistics(cols)
    return {"A": A, "b_hat": b_hat, "sse_min": np.float64(sse_min),
            "n": np.float64(len(cols["kid_score"]))}


def potential(x, config: dict):
    data = const(config, x)
    A, b_hat, sse_min = data["A"], data["b_hat"], data["sse_min"]
    n = float(data["raw"]["n"])
    beta, log_sigma = x[:, :3], x[:, 3]
    sigma = torch.exp(log_sigma)
    r = beta - b_hat
    quad = 0.0
    for j in range(3):                      # rᵀ A r, term by term
        for k in range(3):
            quad = quad + r[:, j] * A[j, k] * r[:, k]
    sse = sse_min + quad
    terms = [LOG_HALF_CAUCHY - torch.log1p((sigma / 2.5) ** 2),
             log_sigma,
             -0.5 * n * (LOG_2PI + 2.0 * log_sigma),
             -0.5 * sse / (sigma * sigma)]
    return total(terms)


def gold(config: dict, n: int, seed: int) -> np.ndarray:
    """``n`` exact posterior draws (n, 4) in [beta(3), log sigma], float64,
    from ``np.random.default_rng(seed)``."""
    cols = columns(config)
    A, b_hat, sse_min = statistics(cols)
    N = float(len(cols["kid_score"]))
    sd = 1.0 / math.sqrt(2.0 * (N - 3.0))
    centre = 0.5 * math.log(sse_min / (N - 3.0))
    grid = centre + sd * np.linspace(-GRID_SD, GRID_SD, GRID_POINTS)
    logp = (LOG_HALF_CAUCHY - np.log1p((np.exp(grid) / 2.5) ** 2) + grid
            - (N - 3.0) * grid - 0.5 * sse_min * np.exp(-2.0 * grid))
    p = np.exp(logp - logp.max())
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (p[1:] + p[:-1])
                                           * np.diff(grid))])
    cdf /= cdf[-1]
    rng = np.random.default_rng(seed)
    s = np.interp(rng.random(n), cdf, grid)
    z = rng.standard_normal((n, 3))
    L = cholesky(A)
    u = [None] * 3
    for i in reversed(range(3)):            # Lᵀ u = z
        t = z[:, i]
        for k in range(i + 1, 3):
            t = t - L[k, i] * u[k]
        u[i] = t / L[i, i]
    sigma = np.exp(s)
    beta = [b_hat[i] + sigma * u[i] for i in range(3)]
    return np.stack(beta + [s], axis=1)
