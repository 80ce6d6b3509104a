"""Carrying ARWMH, ASSS and SA state between the JAX package and the port.

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
"""

from __future__ import annotations

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.kernels.arwmh import ARWMHAdaptState, ARWMHState
from adaptive_mcmc_tpu_torch.kernels.asss import ASSSAdaptState, ASSSState
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
