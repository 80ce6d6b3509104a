"""Shared kernel machinery (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/kernels/base.py``.  A kernel is a pair
``init(generator, n_chains, position) -> State`` /
``step(State, generator) -> State`` over batched ``(C, ...)`` tensors, with
all chains stepping in lockstep.  Where JAX carries per-chain PRNG keys in
the state, the port takes an explicit ``torch.Generator`` per call; a step
also accepts injected draws so that tests can replay another stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A built sampler: init/step closures over (target, config)."""

    name: str
    target: Any
    config: Any
    init: Callable[..., Any]
    step: Callable[..., Any]
    sample_field: str = "position"
    # Optional multi-step driver
    # ``step_n(state, n_steps, generator, noise, unif, *, eager) -> state``;
    # ``eager=True`` asks a driver that replays a CUDA graph (NUTS's
    # machine) for its Python loop, and changes nothing in the others.
    step_n: Any = None
    # Optional thinned-draw collector ``collect_n(state, n_frames, thinning,
    # generator, noise, unif, *, eager) -> (state, {field: (C, F, ...)})``.
    collect_n: Any = None
    # Field names ``collect_n`` records.
    collect_fields: tuple = ()
    # Optional diagnostics probe ``probe(state, n_steps, ...) -> (state,
    # info)`` exposing kernel-internal cost drivers (ASSS: per-chain mean
    # shrinkage trips).
    probe: Any = None
    # Whether ``step`` is a fixed sequence of device work: no value read on
    # the host, no shape that depends on data.  ``run_mcmc`` then captures
    # blocks of steps into a CUDA graph when the state is on a CUDA device.
    graph_step: bool = False


def nan_to_inf(pe: Tensor) -> Tensor:
    """NaN potential -> +inf (reject)."""
    return torch.where(torch.isnan(pe), torch.full_like(pe, float("inf")), pe)


def adaptation_lr(i: Tensor, num_warmup: int, lr_decay: float) -> tuple:
    """(n, gamma) as float32 tensors, with the adaptation clock restarting
    after warmup."""
    itr = i + 1
    n = torch.where(i < num_warmup, itr, itr - num_warmup)
    nf = n.to(torch.float32)
    gamma = nf ** (-lr_decay) if lr_decay != 1.0 else 1.0 / nf
    return n, gamma


def batch_positions(target, generator: torch.Generator | None,
                    n_chains: int, position=None,
                    device: torch.device | str | None = None) -> Tensor:
    """Default per-chain init positions: uniform(-2, 2) in unconstrained
    space (init_to_uniform), or broadcast/validate a provided position."""
    if position is None:
        if generator is None:
            raise ValueError("a torch.Generator is needed to draw positions")
        pos = target.init_position(generator, n_chains)
        return pos if device is None else pos.to(device)
    position = torch.as_tensor(position, dtype=torch.float32, device=device)
    if position.dim() == 1:
        position = position.expand(n_chains, target.dim).clone()
    if tuple(position.shape) != (n_chains, target.dim):
        raise ValueError(
            f"position has shape {tuple(position.shape)}, "
            f"expected {(n_chains, target.dim)}"
        )
    return position
