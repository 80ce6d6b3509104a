"""Finite-difference contraction estimates τ_x(P^n) on 1-D targets
(PyTorch).

Counterpart of ``adaptive_mcmc_tpu/analysis/contraction_curves.py``: for
probe points x and a small offset h, τ_x(P^n) ≈ W_1(P^n(x,·), P^n(x+h,·)) / h
with the closed-form 1-D Wasserstein, the two rollouts coupled by common
random numbers (one seed for both ``sample_pnx`` calls).  Also the frozen
kernels of the synthetic studies (``frozen_arwmh``, ``frozen_asss``)."""

from __future__ import annotations

import math

import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import sample_pnx
from adaptive_mcmc_tpu_torch.kernels.arwmh import (
    ARWMHAdaptState,
    ARWMHConfig,
    arwmh,
)
from adaptive_mcmc_tpu_torch.kernels.asss import (
    ASSSAdaptState,
    ASSSConfig,
    asss,
)
from adaptive_mcmc_tpu_torch.metrics.sliced import wasserstein_1d

Tensor = torch.Tensor


def frozen_arwmh(target, loc: float = 0.0, scale: float = 1.0,
                 step: float = 1.0, device=None):
    """ARWMH with adaptation off and its adapt state: loc, scale · I and
    step size ``step``; returns (kernel, adapt_state)."""
    d = target.dim
    k = arwmh(target, ARWMHConfig(adapt=False))
    adapt = ARWMHAdaptState(
        loc=torch.full((1, d), loc, device=device),
        scale=scale * torch.eye(d, device=device)[None],
        log_step_size=torch.full((1,), math.log(step), device=device),
    )
    return k, adapt


def frozen_asss(target, loc: float = 0.0, scale: float = 1.0, device=None):
    """ASSS with adaptation off and its adapt state (loc, scale · I)."""
    d = target.dim
    k = asss(target, ASSSConfig(adapt=False))
    adapt = ASSSAdaptState(loc=torch.full((1, d), loc, device=device),
                           scale=scale * torch.eye(d, device=device)[None])
    return k, adapt


def _seed(generator) -> int:
    """One seed for a coupled pair of rollouts: ``generator`` itself if it
    is an int, else a draw from it."""
    if isinstance(generator, torch.Generator):
        return int(torch.randint(0, 2**62, (), generator=generator,
                                 device=generator.device))
    return int(generator)


def _coupled(kernel, generator, x_a: Tensor, x_b: Tensor, adapt_state,
             n_steps: int, n_samples: int) -> tuple:
    """P^n rollouts from ``x_a`` and ``x_b`` (n_points,) on one seed."""
    seed = _seed(generator)
    a, b = (sample_pnx(kernel, seed, x[:, None], adapt_state, n=n_steps,
                       n_samples=n_samples)[:, :, 0] for x in (x_a, x_b))
    return a, b


def _probes(generator, xs) -> Tensor:
    device = generator.device if isinstance(generator, torch.Generator) \
        else None
    xs = torch.as_tensor(xs, dtype=torch.float32).reshape(-1)
    return xs if device is None else xs.to(device)


def taus_finite_difference(kernel, generator, xs, adapt_state, *,
                           n_steps: int = 1, n_samples: int = 10_000,
                           h: float = 1e-2, p: float = 1.0) -> Tensor:
    """τ_x(P^n) for each 1-D probe x: the pairs (x, x + h) are rolled
    forward with common random numbers and compared by closed-form W_p
    (without the coupling, the Monte-Carlo noise of W_1 over the small h
    swamps the contraction)."""
    xs = _probes(generator, xs)
    a, b = _coupled(kernel, generator, xs, xs + h, adapt_state, n_steps,
                    n_samples)
    return wasserstein_1d(a, b, p=p) / h


def taus_finite_difference_arctan(kernel, generator, xs, adapt_state, *,
                                  n_steps: int = 1, n_samples: int = 10_000,
                                  eps: float = 1e-1, p: float = 1.0
                                  ) -> Tensor:
    """ASSS's τ probes: perturb the stereographic angle
    φ = 2 arctan((x − loc) / scale) by ±eps, map back to x and divide W_1
    by the induced |Δx|, which keeps the pairs well conditioned in the
    tails the sphere compactifies."""
    xs = _probes(generator, xs)
    loc = torch.as_tensor(adapt_state.loc).reshape(-1)[0].to(xs.device)
    scale = torch.as_tensor(adapt_state.scale).reshape(-1)[0].to(xs.device)
    phi = 2.0 * torch.arctan((xs - loc) / scale)
    x_l = torch.tan((phi - eps) / 2.0) * scale + loc
    x_r = torch.tan((phi + eps) / 2.0) * scale + loc
    a, b = _coupled(kernel, generator, x_l, x_r, adapt_state, n_steps,
                    n_samples)
    return wasserstein_1d(a, b, p=p) / (x_r - x_l)


def contraction_decay_curve(kernel, generator, xs, adapt_state,
                            ns=(1, 2, 4, 8, 16, 32),
                            taus_fn=taus_finite_difference, **kw) -> Tensor:
    """max_x τ_x(P^n) for each n of ``ns``: should fall below 1 and
    decrease.  ``taus_fn`` picks the probe parameterisation (additive for
    RWM-type kernels, :func:`taus_finite_difference_arctan` for ASSS); each
    n draws its own seed from ``generator``."""
    return torch.stack([
        torch.max(taus_fn(kernel, generator, xs, adapt_state,
                          n_steps=int(n), **kw))
        for n in ns])
