"""Carrying ARWMH, ASSS, SA and NUTS state between the JAX package and the port.

This system has no weights: what must match between the two packages is the
kernel state and the target's data.  Targets of both packages take their
data (``y``, ``sigma``) as numpy arrays, so one dataset builds both.  The
kernel state crosses as numpy arrays:

* :func:`arwmh_state_from_numpy` takes any ARWMH-state-shaped object with
  numpy (or array-like) leaves — for example a JAX ``ARWMHState`` passed
  through ``np.asarray`` leaf by leaf — and returns the port's
  ``ARWMHState`` on ``device``.  The JAX state's ``rng_key`` has no
  counterpart: the port takes a ``torch.Generator`` per call.
* :func:`arwmh_state_to_numpy` returns the port's ``ARWMHState`` with numpy
  leaves.
* :func:`asss_state_from_numpy` and :func:`asss_state_to_numpy` do the same
  for ``ASSSState``, whose JAX ``rng_key`` is dropped likewise.
* :func:`sa_state_from_numpy` turns an ``SAState`` (numpy leaves) into the
  port's, dropping ``rng_key`` likewise.
* :func:`nuts_state_from_numpy` and :func:`nuts_state_to_numpy` do the same
  for ``NUTSState`` (its dual-averaging and Welford states included),
  dropping ``rng_key`` likewise.
* :func:`mlp_from_numpy` turns the contraction estimators' JAX
  ``MLPParams(weights, biases)`` (numpy leaves, weights in (in, out)
  layout) into the port's ``LipschitzMLP``; :func:`mlp_to_numpy` gives
  back the ``(weights, biases)`` pair of numpy tuples that
  ``MLPParams(*pair)`` takes.
* :func:`prices_from_numpy` and :func:`prices_to_numpy` carry the
  ε-auction's column duals, so that a JAX solve's prices warm-start the
  port's (``prices_init``) and back.
"""

from __future__ import annotations

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.contraction.lipschitz import LipschitzMLP
from adaptive_mcmc_tpu_torch.kernels.arwmh import ARWMHAdaptState, ARWMHState
from adaptive_mcmc_tpu_torch.kernels.asss import ASSSAdaptState, ASSSState
from adaptive_mcmc_tpu_torch.kernels.nuts import (
    DAState,
    NUTSAdaptState,
    NUTSState,
    WelfordState,
)
from adaptive_mcmc_tpu_torch.kernels.sa import SAAdaptState, SAState


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _i32(a, device):
    return torch.tensor(np.asarray(a, np.int32), device=device)


def _host(t):
    return t.detach().cpu().numpy()


def arwmh_state_from_numpy(state, device=None) -> ARWMHState:
    a = state.adapt_state
    return ARWMHState(
        i=_i32(state.i, device),
        position=_f32(state.position, device),
        potential_energy=_f32(state.potential_energy, device),
        mean_accept_prob=_f32(state.mean_accept_prob, device),
        adapt_state=ARWMHAdaptState(
            loc=_f32(a.loc, device), scale=_f32(a.scale, device),
            log_step_size=_f32(a.log_step_size, device),
        ),
        as_change=_f32(state.as_change, device),
    )


def arwmh_state_to_numpy(state: ARWMHState) -> ARWMHState:
    a = state.adapt_state
    return ARWMHState(
        i=_host(state.i),
        position=_host(state.position),
        potential_energy=_host(state.potential_energy),
        mean_accept_prob=_host(state.mean_accept_prob),
        adapt_state=ARWMHAdaptState(_host(a.loc), _host(a.scale),
                                    _host(a.log_step_size)),
        as_change=_host(state.as_change),
    )


def asss_state_from_numpy(state, device=None) -> ASSSState:
    a = state.adapt_state
    return ASSSState(
        i=_i32(state.i, device),
        position=_f32(state.position, device),
        potential_energy=_f32(state.potential_energy, device),
        adapt_state=ASSSAdaptState(loc=_f32(a.loc, device),
                                   scale=_f32(a.scale, device)),
        as_change=_f32(state.as_change, device),
    )


def asss_state_to_numpy(state: ASSSState) -> ASSSState:
    a = state.adapt_state
    return ASSSState(
        i=_host(state.i),
        position=_host(state.position),
        potential_energy=_host(state.potential_energy),
        adapt_state=ASSSAdaptState(_host(a.loc), _host(a.scale)),
        as_change=_host(state.as_change),
    )


def sa_state_from_numpy(state, device=None) -> SAState:
    a = state.adapt_state
    return SAState(
        i=_i32(state.i, device),
        position=_f32(state.position, device),
        potential_energy=_f32(state.potential_energy, device),
        accept_prob=_f32(state.accept_prob, device),
        mean_accept_prob=_f32(state.mean_accept_prob, device),
        diverging=torch.tensor(np.asarray(state.diverging, bool),
                               device=device),
        adapt_state=SAAdaptState(
            zs=_f32(a.zs, device), pes=_f32(a.pes, device),
            loc=_f32(a.loc, device), scale=_f32(a.scale, device),
        ),
    )


def nuts_state_from_numpy(state, device=None) -> NUTSState:
    a = state.adapt_state
    return NUTSState(
        i=_i32(state.i, device),
        position=_f32(state.position, device),
        potential_energy=_f32(state.potential_energy, device),
        pe_grad=_f32(state.pe_grad, device),
        mean_accept_prob=_f32(state.mean_accept_prob, device),
        num_steps=_i32(state.num_steps, device),
        diverging=torch.tensor(np.asarray(state.diverging, bool),
                               device=device),
        adapt_state=NUTSAdaptState(
            da=DAState(*(_f32(x, device) for x in a.da)),
            inv_mass=_f32(a.inv_mass, device),
            chol_inv_mass=_f32(a.chol_inv_mass, device),
            welford=WelfordState(*(_f32(x, device) for x in a.welford)),
        ),
    )


def nuts_state_to_numpy(state: NUTSState) -> NUTSState:
    a = state.adapt_state
    return NUTSState(
        i=_host(state.i),
        position=_host(state.position),
        potential_energy=_host(state.potential_energy),
        pe_grad=_host(state.pe_grad),
        mean_accept_prob=_host(state.mean_accept_prob),
        num_steps=_host(state.num_steps),
        diverging=_host(state.diverging),
        adapt_state=NUTSAdaptState(
            da=DAState(*map(_host, a.da)),
            inv_mass=_host(a.inv_mass),
            chol_inv_mass=_host(a.chol_inv_mass),
            welford=WelfordState(*map(_host, a.welford)),
        ),
    )


def mlp_from_numpy(params, device=None) -> LipschitzMLP:
    """A ``LipschitzMLP`` holding ``params.weights`` / ``params.biases``."""
    weights = [np.asarray(w, np.float32) for w in params.weights]
    mlp = LipschitzMLP(weights[0].shape[0], weights[0].shape[1],
                       device=device)
    with torch.no_grad():
        for dst, src in zip(mlp.weights, weights):
            dst.copy_(_f32(src, device))
        for dst, src in zip(mlp.biases, params.biases):
            dst.copy_(_f32(src, device))
    return mlp


def mlp_to_numpy(mlp: LipschitzMLP) -> tuple:
    """``(weights, biases)``, each a tuple of numpy arrays."""
    return (tuple(_host(w) for w in mlp.weights),
            tuple(_host(b) for b in mlp.biases))


def prices_from_numpy(prices, device=None) -> torch.Tensor:
    """Auction prices (m,) or (B, m) as a float32 tensor on ``device``."""
    return _f32(prices, device)


def prices_to_numpy(prices: torch.Tensor) -> np.ndarray:
    return _host(prices)
