"""Entropy-regularised optimal transport, log-domain Sinkhorn (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/metrics/sinkhorn.py``, with its
conventions: the ground cost is the Euclidean distance, the default
epsilon is 0.05 x the mean cost, and the value is the dual objective
<f, a> + <g, b>.  The solver runs blocks of ``inner_iters`` pairs of
logsumexp updates and checks the marginal after each block: one read on
the host per block.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from adaptive_mcmc_tpu_torch.metrics.moments import as_f32

Tensor = torch.Tensor


def _euclidean_cost(x: Tensor, y: Tensor) -> Tensor:
    xx = torch.sum(x * x, dim=1)
    yy = torch.sum(y * y, dim=1)
    sq = torch.clamp_min(xx[:, None] + yy[None, :] - 2.0 * (x @ y.T), 0.0)
    return torch.sqrt(sq + 1e-30)


def _solve(cost: Tensor, epsilon: Tensor, tol: float, max_iters: int,
           inner_iters: int = 10):
    """(dual value, f, g, marginal error, iterations) of the log-domain
    Sinkhorn iteration on ``cost`` (n, m) with uniform weights."""
    n, m = cost.shape
    dev = cost.device
    log_a = torch.full((n,), -math.log(n), device=dev)
    log_b = torch.full((m,), -math.log(m), device=dev)

    def marginal_err(f, g):
        # L1 deviation of the plan's row marginals from a (about 2 when
        # completely off)
        log_pi = (f[:, None] + g[None, :] - cost) / epsilon
        row = torch.logsumexp(log_pi + log_b[None, :], dim=1)
        return torch.sum(torch.abs(torch.exp(row) - torch.exp(log_a)))

    f = torch.zeros((n,), device=dev)
    g = torch.zeros((m,), device=dev)
    err, it = math.inf, 0
    while err > tol and it < max_iters:
        for _ in range(inner_iters):
            f = -epsilon * torch.logsumexp(
                (g[None, :] - cost) / epsilon + log_b[None, :], dim=1)
            g = -epsilon * torch.logsumexp(
                (f[:, None] - cost) / epsilon + log_a[:, None], dim=0)
        err_t = marginal_err(f, g)
        err, it = float(err_t), it + inner_iters
    value = torch.sum(f * torch.exp(log_a)) + torch.sum(g * torch.exp(log_b))
    return value, f, g, err, it


def wasserstein_sinkhorn(u_values, v_values, epsilon: Optional[float] = None,
                         tol: float = 0.05, max_iters: int = 500) -> float:
    """Entropy-regularised OT cost between two point clouds with uniform
    weights.  ``tol`` bounds the L1 deviation of the plan's row marginals;
    the cost converges much faster than the marginals, so it is loose."""
    u, v = as_f32(u_values), as_f32(v_values)
    cost = _euclidean_cost(u, v.to(u.device))
    eps = torch.mean(cost) * 0.05 if epsilon is None \
        else torch.tensor(epsilon, dtype=torch.float32, device=cost.device)
    return float(_solve(cost, eps, tol, max_iters)[0])


def wasserstein_sinkhorn_unbiased(u_values, v_values,
                                  epsilon: Optional[float] = None,
                                  tol: float = 1e-3,
                                  max_iters: int = 2000) -> float:
    """Sinkhorn divergence W(u, v) - (W(u, u) + W(v, v)) / 2."""
    kw = dict(epsilon=epsilon, tol=tol, max_iters=max_iters)
    wuv = wasserstein_sinkhorn(u_values, v_values, **kw)
    wuu = wasserstein_sinkhorn(u_values, u_values, **kw)
    wvv = wasserstein_sinkhorn(v_values, v_values, **kw)
    return wuv - 0.5 * (wuu + wvv)
