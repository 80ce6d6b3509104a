"""Moment-based sample-quality metrics (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/metrics/moments.py``."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def as_f32(x) -> Tensor:
    """``x`` as a float32 tensor, on its own device if it is a tensor."""
    return torch.as_tensor(x, dtype=torch.float32)


def pth_moment_rmse(x, y, p: float = 2.0) -> Tensor:
    """L2 norm of the difference of p-th raw-moment estimates between two
    (n, d) sample sets; ``rmse_means`` of the eval scripts uses p = 1."""
    x, y = as_f32(x), as_f32(y)
    mx = torch.mean(x**p, dim=0)
    my = torch.mean(y**p, dim=0)
    return torch.linalg.vector_norm(mx - my)
