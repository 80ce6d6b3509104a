"""Chain-parallel execution on one device (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/parallel/run.py`` on the port's one
device: :func:`run_mcmc_sharded` runs a warmup and a thinned collection in
bounded calls with an optional post-warmup fan-out (:func:`fan_state`),
as the experiment harness drives every sweep, and the collectives
:func:`cross_chain_moments` and :func:`sharded_gelman_rubin`, written as
the JAX package's are: per-device partial sums, then one reduction each
over the chain axis (:func:`_chain_sum`), which is the identity on the one
device.  Splitting the chain axis over several devices waits for
torch.distributed (ROADMAP A15), which puts an all-reduce there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import (
    MAX_GRAPH_STEPS,
    advancer,
    map_state,
)
from adaptive_mcmc_tpu_torch.parallel.mesh import chain_mesh


def fan_state(state, fan: int):
    """Clone every chain ``fan`` times, clones contiguous per chain: each
    per-chain tensor (C, ...) tiles to (C*fan, ...) by ``repeat_interleave``.
    The port's states carry no per-chain keys: the clones draw from the
    run's generator like any other chains, so each gets its own draws.

    Statistical note: cloning a chain state and continuing with fresh draws
    preserves the chain's marginal distribution exactly — for kernels whose
    post-warmup transition is frozen (NUTS, SA after adaptation) the pooled
    clone draws are distributed identically to one long chain's.  For
    still-adapting kernels (ARWMH/ASSS diminishing adaptation) each clone
    runs its own post-warmup adaptation clock, so fanning trades a shorter
    per-clone adaptation tail for wall-clock — verify quality parity before
    adopting it for those."""
    C = state.position.shape[0]

    def tile(t):
        if t.dim() >= 1 and t.shape[0] == C:
            return t.repeat_interleave(fan, dim=0)
        return t

    return map_state(tile, state)


def run_mcmc_sharded(
    kernel,
    generator: torch.Generator,
    num_warmup: int,
    num_samples: int,
    *,
    thinning: int = 1,
    n_chains: int,
    mesh: Optional[torch.device] = None,
    init_position=None,
    extra_fields: Sequence[str] = (),
    init_state=None,
    max_steps_per_call: Optional[int] = None,
    fan_out: int = 1,
    eager: bool = False,
):
    """``infer.run_mcmc`` in bounded calls: the JAX function's semantics on
    the one device of ``mesh`` (:func:`chain_mesh`; by default the
    generator's device, which must be the mesh's).

    ``max_steps_per_call`` bounds the steps of one call of the kernel's
    driver: the warmup runs in chunks of that many steps, the collection in
    chunks of ``max_steps_per_call // thinning`` frames.  Where the kernel
    buffers every requested field (``collect_n``: ASSS, NUTS, fused ARWMH)
    each chunk is one ``collect_n`` call, otherwise the thinned frames are
    read after each ``thinning`` steps of the advancer (``infer.mcmc
    .advancer``: ``step_n`` where the kernel has one, the CUDA graph of
    lockstep steps on the card, the Python loop elsewhere).  For a lockstep
    kernel a chunk boundary changes no draw: chunked equals unchunked bit
    for bit.  A pipelined machine (ASSS, NUTS) ends each call at a barrier
    where every chain has made its steps, as the JAX machine does, so there
    the chunks change the draws but not their distribution.

    ``fan_out=F`` warms up ``n_chains`` chains, then clones each into F
    chains (:func:`fan_state`) and collects ``num_samples // F`` sampling
    iterations per clone — the total sampling work is unchanged but runs
    F-wide.  Returns ``(samples, extras, last_state)``: ``samples``
    (frames, n_chains*F, d) and each extra field (frames, n_chains*F, ...),
    clone-major within each original chain."""
    if mesh is None:
        mesh = chain_mesh(devices=[generator.device]) \
            if generator is not None else chain_mesh()
    if generator is not None and generator.device != torch.device(mesh):
        raise ValueError(f"the generator is on {generator.device}, the mesh "
                         f"on {mesh}")
    if num_samples % (thinning * fan_out):
        raise ValueError("num_samples must divide by thinning * fan_out")
    num_collect = num_samples // thinning // fan_out
    sample_field = kernel.sample_field
    fields = (sample_field, *extra_fields)
    collect_n = kernel.collect_n
    if collect_n is not None and not set(fields) <= set(kernel.collect_fields):
        collect_n = None        # a requested field is not buffered

    state = init_state if init_state is not None else kernel.init(
        generator, n_chains=n_chains, position=init_position, device=mesh)
    block = min(thinning, MAX_GRAPH_STEPS)
    advance = advancer(kernel, generator, state, block, eager)
    cap = max_steps_per_call or max(num_warmup + num_samples, 1)
    done = 0
    while done < num_warmup:
        todo = min(cap, num_warmup - done)
        state = advance(state, todo)
        done += todo

    if fan_out > 1:
        state = fan_state(state, fan_out)
        advance = advancer(kernel, generator, state, block, eager)

    if collect_n is not None and num_collect:
        frames_per_call = max(1, cap // thinning)
        chunks = []
        collected = 0
        while collected < num_collect:
            todo = min(frames_per_call, num_collect - collected)
            state, bufs = collect_n(state, todo, thinning, generator,
                                    eager=eager)
            # (C, F, ...) per chain -> (F, C, ...)
            chunks.append({f: bufs[f].transpose(0, 1) for f in fields})
            collected += todo
        out = {f: torch.cat([c[f] for c in chunks]) if len(chunks) > 1
               else chunks[0][f] for f in fields}
    else:
        out = {f: torch.empty((num_collect,) + tuple(getattr(state, f).shape),
                              dtype=getattr(state, f).dtype,
                              device=getattr(state, f).device)
               for f in fields}
        for k in range(num_collect):
            state = advance(state, thinning)
            for f in fields:
                out[f][k] = getattr(state, f)
    samples = out.pop(sample_field)
    return samples, out, state


# ---------------------------------------------------------------------------
# Collective diagnostics: per-device partial sums, reduced over the chain
# axis (JAX: lax.psum over the chains mesh axis).
# ---------------------------------------------------------------------------

def _chain_sum(partial: torch.Tensor) -> torch.Tensor:
    """The sum of a per-device partial over the devices of the chain axis:
    the identity on the port's one device."""
    return partial


def cross_chain_moments(x: torch.Tensor,
                        mesh: Optional[torch.device] = None):
    """Global (mean, var) over the chain axis of a (C, ...) tensor without
    gathering: per-device partial sums + one reduction each.  ``mesh`` is
    the device of :func:`chain_mesh` (by default ``x``'s)."""
    if mesh is not None:
        x = x.to(mesh)
    n = _chain_sum(torch.tensor(float(x.shape[0]), device=x.device))
    s = _chain_sum(torch.sum(x, dim=0))
    s2 = _chain_sum(torch.sum(x * x, dim=0))
    mean = s / n
    var = s2 / n - mean * mean
    return mean, var


def sharded_gelman_rubin(samples: torch.Tensor,
                         mesh: Optional[torch.device] = None):
    """Split-R̂ of (draws, chains, ...) samples with the chains on their
    devices: per-chain means and variances where the chains live, then
    reductions of O(params) numbers, never of the draws."""
    x = samples if mesh is None else samples.to(mesh)
    half = x.shape[0] // 2
    x = torch.cat([x[:half], x[half:2 * half]], dim=1)
    n = x.shape[0]
    cm = torch.mean(x, dim=0)
    cv = torch.var(x, dim=0, correction=1)
    m = _chain_sum(torch.tensor(float(x.shape[1]), device=x.device))
    w = _chain_sum(torch.sum(cv, dim=0)) / m
    mean_all = _chain_sum(torch.sum(cm, dim=0)) / m
    b = n * _chain_sum(torch.sum((cm - mean_all) ** 2, dim=0)) / (m - 1.0)
    var_hat = (n - 1) / n * w + b / n
    return torch.sqrt(var_hat / w)
