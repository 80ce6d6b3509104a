"""Invariance checks, πP = π made quantitative (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/analysis/invariance.py``: exact samples
pushed through the kernel are compared with a fresh exact sample by a
two-sample Kolmogorov-Smirnov statistic, so a fixed seed can assert
invariance."""

from __future__ import annotations

from typing import Callable

import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import sample_pnx

Tensor = torch.Tensor


def push_through_kernel(kernel, generator, exact_samples, n_steps: int = 1,
                        adapt_state=None) -> Tensor:
    """``n_steps`` kernel transitions (frozen adaptation) of each row of
    ``exact_samples`` (n, d); returns the pushed batch (n, d).  Without an
    ``adapt_state``, the kernel's initial one at the origin."""
    if adapt_state is None:
        st = kernel.init(torch.Generator().manual_seed(0), n_chains=1,
                         position=torch.zeros((1, kernel.target.dim)))
        adapt_state = st.adapt_state
    out = sample_pnx(kernel, generator, exact_samples, adapt_state,
                     n=n_steps, n_samples=1)
    return out[:, 0, :]


def ks_statistic(a, b) -> Tensor:
    """Two-sample KS statistic of 1-D samples (exact, by sorting)."""
    a = torch.sort(torch.as_tensor(a).reshape(-1)).values
    b = torch.sort(torch.as_tensor(b).reshape(-1)).values.to(a.device)
    n, m = a.shape[0], b.shape[0]
    all_v = torch.cat([a, b])
    cdf_a = torch.searchsorted(a, all_v, right=True) / n
    cdf_b = torch.searchsorted(b, all_v, right=True) / m
    return torch.max(torch.abs(cdf_a - cdf_b))


def invariance_ks(kernel, exact_sampler: Callable, generator,
                  n_samples: int = 100_000, n_steps: int = 1,
                  adapt_state=None) -> float:
    """KS statistic between an exact sample pushed through P^n_steps and an
    independent exact sample.  ``exact_sampler(generator, n)`` draws n
    exact samples.  Under πP = π this is the null two-sample KS, whose
    99.9% quantile is about 1.95 sqrt(2 / n)."""
    x = exact_sampler(generator, n_samples)
    if x.dim() == 1:
        x = x[:, None]
    pushed = push_through_kernel(kernel, generator, x, n_steps, adapt_state)
    y = exact_sampler(generator, n_samples)
    return float(ks_statistic(pushed[:, 0],
                              y.reshape(-1, x.shape[1])[:, 0]))


def ks_null_threshold(n: int, alpha_sigma: float = 1.95) -> float:
    """Approximate upper bound of the two-sample KS statistic under the
    null (both samples of size n): c(α) sqrt(2 / n); 1.95 is about
    α = 0.001."""
    return alpha_sigma * (2.0 / n) ** 0.5
