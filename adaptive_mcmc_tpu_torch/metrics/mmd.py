"""Maximum-mean-discrepancy metrics (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/metrics/mmd.py``.  The Gram matrices
come from squared norms and one (n, d) @ (d, m) product (float32 in full
precision: the package turns TF32 off at import).

The median heuristic takes the mean of the two middle order statistics of
an even count, as ``jnp.median`` does at the counts where its float32 index
arithmetic is exact (below 2^24 entries).  ``torch.median`` returns the
lower one, and ``torch.quantile`` refuses more than 2^24 elements (a 10k x
10k distance matrix has 10^8), so the order statistics come from a sort.
"""

from __future__ import annotations

import torch

from adaptive_mcmc_tpu_torch.metrics.moments import as_f32

Tensor = torch.Tensor


def _sq_dists(x: Tensor, y: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances by the Gram form."""
    xx = torch.sum(x * x, dim=1)
    yy = torch.sum(y * y, dim=1)
    return torch.clamp_min(xx[:, None] + yy[None, :] - 2.0 * (x @ y.T), 0.0)


def gaussian_kernel(x, y, gamma) -> Tensor:
    """RBF Gram matrix exp(-gamma * ||x_i - y_j||^2), shape (n, m)."""
    return torch.exp(-gamma * _sq_dists(as_f32(x), as_f32(y)))


def median(values: Tensor) -> Tensor:
    """Median of all entries: the middle order statistic of an odd count,
    the mean of the two middle ones of an even count."""
    flat = torch.sort(values.reshape(-1)).values
    k = flat.numel() // 2
    if flat.numel() % 2:
        return flat[k]
    return (flat[k - 1] + flat[k]) * 0.5


def median_sq_dist(y) -> Tensor:
    """Median of pairwise squared distances (bandwidth heuristic)."""
    y = as_f32(y)
    return median(_sq_dists(y, y))


def mmd2_unbiased(x, y, gamma=1.0) -> Tensor:
    """U-statistic estimator of MMD^2 (diagonals excluded)."""
    x, y = as_f32(x), as_f32(y)
    n, m = x.shape[0], y.shape[0]
    kxx = torch.sum(gaussian_kernel(x, x, gamma)) - n  # diagonal entries 1
    kyy = torch.sum(gaussian_kernel(y, y, gamma)) - m
    kxy = torch.sum(gaussian_kernel(x, y, gamma))
    return kxx / (n * (n - 1)) + kyy / (m * (m - 1)) - 2.0 * kxy / (n * m)


def _biased(kxx: Tensor, kyy: Tensor, kxy: Tensor, n: int, m: int) -> Tensor:
    # clamped: x == y makes the biased estimate 0 up to rounding, and the
    # square root of a negative rounding error would be NaN
    return torch.sqrt(torch.clamp_min(
        kxx / n**2 + kyy / m**2 - 2.0 * kxy / (n * m), 0.0))


def mmd_heuristic(x, y) -> Tensor:
    """Biased MMD with the median-heuristic bandwidth gamma =
    4 / median(||y_i - y_j||^2): the metric of every eval script."""
    x, y = as_f32(x), as_f32(y)
    gamma = 4.0 / median_sq_dist(y)
    return _biased(torch.sum(gaussian_kernel(x, x, gamma)),
                   torch.sum(gaussian_kernel(y, y, gamma)),
                   torch.sum(gaussian_kernel(x, y, gamma)),
                   x.shape[0], y.shape[0])


def mmd_heuristic_many(xs, y) -> Tensor:
    """``mmd_heuristic`` of each sample set of ``xs`` (S, n, d) against one
    reference ``y`` (m, d) -> (S,).  The bandwidth and the y-y Gram sum
    depend on y alone and are computed once; the sets run one after the
    other, so the peak memory stays one (n, m) Gram matrix."""
    xs, y = as_f32(xs), as_f32(y)
    gamma = 4.0 / median_sq_dist(y)
    kyy = torch.sum(gaussian_kernel(y, y, gamma))
    return torch.stack([
        _biased(torch.sum(gaussian_kernel(x, x, gamma)), kyy,
                torch.sum(gaussian_kernel(x, y, gamma)),
                xs.shape[1], y.shape[0])
        for x in xs])
