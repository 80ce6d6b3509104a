"""Exact Wasserstein by the optimal 1-1 coupling: the primary eval metric
(PyTorch).

Counterpart of ``adaptive_mcmc_tpu/metrics/wasserstein.py``: the (n, n)
Minkowski cost matrix is built on the device of the samples (one product
for ord = 2, float32 in full precision: the package turns TF32 off at
import), the assignment comes from the exact host solvers or the
ε-auction on the device, and the value is the mean assigned distance."""

from __future__ import annotations

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.metrics.assignment import (
    auction_assignment,
    linear_sum_assignment,
)
from adaptive_mcmc_tpu_torch.metrics.moments import as_f32

Tensor = torch.Tensor


def minkowski_cost_matrix(u, v, ord: float = 2.0) -> Tensor:
    """Pairwise Minkowski-``ord`` distances (n, m).  ord = 2 uses the Gram
    form; other orders broadcast."""
    u = as_f32(u)
    v = as_f32(v).to(u.device)
    if ord == 2.0:
        uu = torch.sum(u * u, dim=1)
        vv = torch.sum(v * v, dim=1)
        sq = torch.clamp_min(uu[:, None] + vv[None, :] - 2.0 * (u @ v.T),
                             0.0)
        return torch.sqrt(sq)
    diff = torch.abs(u[:, None, :] - v[None, :, :])
    return torch.sum(diff**ord, dim=-1) ** (1.0 / ord)


def wasserstein_dist11_p(u_values, v_values, ord: float = 2.0,
                         solver: str = "auto", prices_init=None,
                         return_prices: bool = False):
    """Mean distance under the optimal 1-1 coupling of two equal-size
    sample sets.  ``solver``: "auto" | "native" | "scipy" (exact, host) or
    "auction" (within ε_final, on the device).  For the auction,
    ``prices_init`` / ``return_prices`` carry the column duals from one
    solve to the next against the same reference set."""
    cost = minkowski_cost_matrix(u_values, v_values, ord=ord)
    n = cost.shape[0]
    rows = torch.arange(n, device=cost.device)
    if solver == "auction":
        out = auction_assignment(cost, prices_init=prices_init,
                                 return_prices=return_prices)
        col, prices = out if return_prices else (out, None)
        w = float(torch.mean(cost[rows, col]))
        return (w, prices) if return_prices else w
    cost_np = cost.cpu().numpy()
    col = linear_sum_assignment(cost_np, solver=solver)
    return float(cost_np[np.arange(n), col].mean())
