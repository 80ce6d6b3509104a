"""1-D and sliced Wasserstein distances (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/metrics/sliced.py``: the 1-D W_p is a
sort and a difference, batched over leading axes, so the sliced forms are
one (n, d) @ (d, D) projection per sample set and a batched sort.  The
directions come from a ``torch.Generator``; the math after the draw takes
them as an argument (:func:`sliced_from_directions`), so that a test can
feed it the directions of ``jax.random.normal(key, (D, d))``.
"""

from __future__ import annotations

import torch

from adaptive_mcmc_tpu_torch.metrics.moments import as_f32

Tensor = torch.Tensor


def wasserstein_1d(mu, nu, p: float = 1.0) -> Tensor:
    """Closed-form 1-D W_p between equal-size empirical measures by sorting
    and differencing; batched over leading axes."""
    mu, nu = as_f32(mu), as_f32(nu)
    diff = torch.abs(torch.sort(mu, dim=-1).values
                     - torch.sort(nu, dim=-1).values)
    return torch.mean(diff**p, dim=-1) ** (1.0 / p)


def directions(generator: torch.Generator, n_directions: int, d: int,
               device) -> Tensor:
    """``n_directions`` standard normal draws in R^d (rows not yet
    normalised), drawn on the generator's device and moved to ``device``."""
    dirs = torch.randn((n_directions, d), generator=generator,
                       device=generator.device)
    return dirs.to(device)


def sliced_from_directions(mu, nu, dirs, p: float = 1.0) -> Tensor:
    """W_p of the projections of ``mu`` and ``nu`` (n, d) on each row of
    ``dirs`` (D, d), normalised here: returns (D,)."""
    mu, nu = as_f32(mu), as_f32(nu)
    dirs = as_f32(dirs).to(mu.device)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    return wasserstein_1d((mu @ dirs.T).T, (nu @ dirs.T).T, p=p)


def max_sliced_wasserstein(mu, nu, generator: torch.Generator,
                           p: float = 1.0, n_directions: int = 1000) -> Tensor:
    """Max over random unit directions of the 1-D W_p of the
    projections."""
    mu = as_f32(mu)
    dirs = directions(generator, n_directions, mu.shape[1], mu.device)
    return torch.max(sliced_from_directions(mu, nu, dirs, p))


def sliced_wasserstein(mu, nu, generator: torch.Generator, p: float = 1.0,
                       n_directions: int = 1000) -> Tensor:
    """Mean (rather than max) over directions: the standard SW distance."""
    mu = as_f32(mu)
    dirs = directions(generator, n_directions, mu.shape[1], mu.device)
    w = sliced_from_directions(mu, nu, dirs, p)
    return torch.mean(w**p) ** (1.0 / p)
