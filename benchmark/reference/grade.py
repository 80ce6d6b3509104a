"""The grading metrics of one set of draws against the reference draws,
by their definitions, in the dtype asked for (float64 for the reference,
bfloat16 for the control):

* exact W: the mean Euclidean distance under the optimal 1-1 coupling of
  the set's n rows with the reference's first n rows (SciPy's exact
  linear sum assignment on the cost matrix);
* MMD: the biased estimate with the Gaussian kernel
  exp(−γ‖x − y‖²), γ = 4 / the median of the reference's pairwise squared
  distances (all m² entries, the mean of the two middle ones);
* rmse_means: the Euclidean norm of the difference of the means."""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist


def _t(a, dtype: str):
    return torch.as_tensor(np.asarray(a, np.float64)).to(getattr(torch,
                                                                 dtype))


def _sq_dists(x, y):
    return torch.clamp_min(torch.sum(x * x, 1)[:, None]
                           + torch.sum(y * y, 1)[None, :] - 2.0 * (x @ y.T),
                           0.0)


def cost_matrix(x, y, dtype: str = "float64") -> np.ndarray:
    if dtype == "float64":
        return cdist(np.asarray(x, np.float64), np.asarray(y, np.float64))
    return torch.sqrt(_sq_dists(_t(x, dtype), _t(y, dtype))).to(
        torch.float64).numpy()


def exact_w(x, y, dtype: str = "float64") -> float:
    """W of the set ``x`` against the first len(x) rows of ``y``."""
    n = min(len(x), len(y))
    cost = cost_matrix(x[:n], y[:n], dtype)
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].mean())


def cost_range(x, y) -> float:
    n = min(len(x), len(y))
    cost = cost_matrix(x[:n], y[:n])
    return float(cost.max() - cost.min())


class MMD:
    """The reference draws' bandwidth and kernel sum, computed once, in
    blocks of rows."""

    def __init__(self, y, dtype: str = "float64", block: int = 1024):
        self.dtype, self.block = dtype, block
        self.y = _t(y, dtype)
        m = self.y.shape[0]
        d2 = torch.cat([_sq_dists(self.y[i:i + block], self.y)
                        for i in range(0, m, block)]).reshape(-1)
        k = d2.numel() // 2
        lo_hi = torch.kthvalue(d2.to(torch.float64), k).values, \
            torch.kthvalue(d2.to(torch.float64), k + 1).values
        med = (lo_hi[0] + lo_hi[1]) * 0.5 if d2.numel() % 2 == 0 else lo_hi[1]
        self.gamma = (4.0 / med).to(self.y.dtype)
        del d2
        self.kyy = self._ksum(self.y, self.y)

    def _ksum(self, a, b):
        return sum(torch.sum(torch.exp(-self.gamma * _sq_dists(
            a[i:i + self.block], b))) for i in range(0, a.shape[0],
                                                     self.block))

    def __call__(self, x) -> float:
        x = _t(x, self.dtype)
        n, m = x.shape[0], self.y.shape[0]
        v = self._ksum(x, x) / n ** 2 + self.kyy / m ** 2 \
            - 2.0 * self._ksum(x, self.y) / (n * m)
        return float(torch.sqrt(torch.clamp_min(v.to(torch.float64), 0.0)))


def rmse_means(x, y, dtype: str = "float64") -> float:
    mx = torch.mean(_t(x, dtype), dim=0)
    my = torch.mean(_t(y, dtype), dim=0)
    return float(torch.linalg.vector_norm(mx - my).to(torch.float64))
