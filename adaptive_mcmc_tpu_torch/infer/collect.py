"""Log-scale trajectory collection (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/infer/collect.py``: collect whole kernel
states on a log-spaced iteration grid (at most 100 points per decade over
10^n_pow iterations), including the ``as_change`` adaptation-drift
diagnostic the lr-decay plots are built from.  The steps between two grid
points go through :func:`~adaptive_mcmc_tpu_torch.infer.mcmc.advancer`, as
in ``run_mcmc``: ``step_n`` where the kernel has one, otherwise, on the
card, a CUDA graph of lockstep steps (ARWMH, RWM, SA; blocks of the
largest divisor of the thinning up to ``MAX_GRAPH_STEPS``, so that a grid
interval is whole replays) or of ASSS's lockstep parts, otherwise a Python
loop.
"""

from __future__ import annotations

import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import (
    MAX_GRAPH_STEPS,
    advancer,
    map_state,
)

Tensor = torch.Tensor


def ns_logscale(n_pow: int = 6) -> Tensor:
    """Iteration indices of collected states: per-decade thinning
    10^max(0, p-2) (kernel_utils.py:8-12)."""
    chunks = []
    for p in range(n_pow + 1):
        lower = 0 if p < 1 else 10 ** (p - 1)
        thin = 10 ** max(0, p - 2)
        chunks.append(torch.arange(lower, 10**p, thin, dtype=torch.int32)
                      + thin)
    return torch.cat(chunks)


def concat_trees(trees):
    """Leafwise concatenation of a list of states (kernel_utils.py:14-18)."""
    return map_state(lambda *ls: torch.cat(ls), *trees)


def collect_states_logscale(
    kernel,
    generator: torch.Generator,
    *,
    n_pow: int = 6,
    n_chains: int = 1,
    init_position=None,
    max_steps_per_call: int | None = None,
    device=None,
):
    """Run 10^n_pow iterations, collecting a copy of the whole state at
    each point of the log grid.  Returns ``(states, last_state)``, where
    every tensor of ``states`` has a leading axis of len(ns_logscale(n_pow))
    (then that of the state's own tensor).

    ``max_steps_per_call`` cuts each decade into segments of at most that
    many steps (whole grid intervals), each stacked on its own before the
    segments are concatenated; the grid and the draws are the same."""
    state = kernel.init(generator, n_chains=n_chains,
                        position=init_position, device=device)
    collections = []
    for p in range(n_pow + 1):
        lower = 0 if p < 1 else 10 ** (p - 1)
        thin = 10 ** max(0, p - 2)
        total_len = (10**p - lower) // thin
        chunk_len = (
            total_len
            if max_steps_per_call is None
            else max(1, min(total_len, max_steps_per_call // thin))
        )
        advance = advancer(kernel, generator, state,
                           max(b for b in range(1, MAX_GRAPH_STEPS + 1)
                               if thin % b == 0))
        off = 0
        while off < total_len:
            length = min(chunk_len, total_len - off)
            frames = []
            for _ in range(length):
                state = advance(state, thin)
                frames.append(map_state(torch.clone, state))
            collections.append(map_state(lambda *ls: torch.stack(ls),
                                         *frames))
            off += length
    return concat_trees(collections), map_state(torch.clone, state)
