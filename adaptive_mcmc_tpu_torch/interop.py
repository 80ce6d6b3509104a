"""Carrying ARWMH state between the JAX package and the port.

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
"""

from __future__ import annotations

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.kernels.arwmh import ARWMHAdaptState, ARWMHState


def arwmh_state_from_numpy(state, device=None) -> ARWMHState:
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    a = state.adapt_state
    return ARWMHState(
        i=torch.tensor(np.asarray(state.i, np.int32), device=device),
        position=f32(state.position),
        potential_energy=f32(state.potential_energy),
        mean_accept_prob=f32(state.mean_accept_prob),
        adapt_state=ARWMHAdaptState(
            loc=f32(a.loc), scale=f32(a.scale),
            log_step_size=f32(a.log_step_size),
        ),
        as_change=f32(state.as_change),
    )


def arwmh_state_to_numpy(state: ARWMHState) -> ARWMHState:
    def host(t):
        return t.detach().cpu().numpy()

    a = state.adapt_state
    return ARWMHState(
        i=host(state.i),
        position=host(state.position),
        potential_energy=host(state.potential_energy),
        mean_accept_prob=host(state.mean_accept_prob),
        adapt_state=ARWMHAdaptState(host(a.loc), host(a.scale),
                                    host(a.log_step_size)),
        as_change=host(state.as_change),
    )
