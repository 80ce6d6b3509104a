"""Chain-parallel execution over a chain mesh (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/parallel/run.py``.  Where JAX runs one
program over a sharded chain axis, each process of the port's mesh
(``parallel.mesh``: one process per device) runs its own block of the
chains with the ordinary drivers:

1. :func:`run_mcmc_sharded` runs a warmup and a thinned collection of the
   process's block in bounded calls, with an optional post-warmup fan-out
   (:func:`fan_state`), as the experiment harness drives every sweep, then
   gathers the draws over the mesh (:func:`gather_chains`).  A step makes
   no collective: the gather is the only one, a fixed number per run.

2. The collectives :func:`cross_chain_moments` and
   :func:`sharded_gelman_rubin`, written as the JAX package's are: partial
   sums over the process's block, then one all-reduce each over the mesh
   (:func:`_chain_sum`; JAX's ``psum``), O(params) numbers, never draws.

:func:`run_mcmc_sharded` records the spans ``run_mcmc_sharded.warmup`` and
``run_mcmc_sharded.collect`` per chunk and ``run_mcmc_sharded.gather``
(``utils.profiling``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from adaptive_mcmc_tpu_torch.infer.mcmc import (
    _collect,
    advancer,
    map_state,
)
from adaptive_mcmc_tpu_torch.parallel.mesh import (
    ChainMesh,
    chain_sharding,
    process_device,
    rank_generator,
)
from adaptive_mcmc_tpu_torch.utils import profiling


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


def gather_chains(block: torch.Tensor, mesh: ChainMesh,
                  dim: int = 0) -> torch.Tensor:
    """The whole chain axis (``dim``) from every process's block of it,
    rank-major, on every process: one all-reduce (sum) of a zero-filled
    buffer into which each process writes its block, which every backend
    takes for CUDA tensors (gloo's all_gather does not).  Exact: each entry
    is one block's value plus zeros.  A bool tensor crosses as uint8."""
    if mesh.size == 1:
        return block
    b = block.shape[dim]
    src = block.to(torch.uint8) if block.dtype == torch.bool else block
    shape = list(block.shape)
    shape[dim] = b * mesh.size
    full = torch.zeros(shape, dtype=src.dtype, device=block.device)
    full.narrow(dim, mesh.rank * b, b).copy_(src)
    dist.all_reduce(full, group=mesh.group)
    return full.bool() if block.dtype == torch.bool else full


def run_mcmc_sharded(
    kernel,
    generator: torch.Generator,
    num_warmup: int,
    num_samples: int,
    *,
    thinning: int = 1,
    n_chains: int,
    mesh: Optional[ChainMesh] = None,
    init_position=None,
    extra_fields: Sequence[str] = (),
    init_state=None,
    max_steps_per_call: Optional[int] = None,
    fan_out: int = 1,
    eager: bool = False,
):
    """``infer.run_mcmc`` in bounded calls, with the chain axis split over
    ``mesh`` (:func:`chain_mesh`): each process runs its block of
    ``n_chains / mesh.size`` chains (``n_chains`` must divide) on its
    device.  By default ``mesh`` is this process alone on the generator's
    device (JAX's default is every device: the port makes no collective
    unasked).

    Random streams: rank 0 draws from ``generator`` as one process would,
    so a one-rank mesh gives exactly what one process gives; rank r > 0
    draws from ``parallel.mesh.rank_generator(generator, r)`` (a function
    of the generator's state and r) and leaves ``generator`` at that
    generator's final state.  Each block therefore equals, bit for bit, a
    one-process run of ``n_chains / mesh.size`` chains from the rank's
    generator; unlike JAX's, the gathered run is not the unsharded one.
    ``init_position`` is the whole (n_chains, d) array (each process takes
    its rows) or one position for every chain; ``init_state`` is the
    process's block.

    ``max_steps_per_call`` bounds the steps of one call of the kernel's
    driver: the warmup runs in chunks of that many steps, the collection in
    chunks of ``max_steps_per_call // thinning`` frames, each chunk
    ``run_mcmc``'s collection (``infer.mcmc._collect``: one ``collect_n``
    call where the kernel buffers every requested field, otherwise the
    thinned frame loop over the run's advancer).  For a lockstep kernel a
    chunk boundary changes no draw: chunked equals unchunked bit for bit.
    A pipelined machine (ASSS, NUTS) ends each call at a barrier where
    every chain has made its steps, as the JAX machine does, so there the
    chunks change the draws but not their distribution.

    ``fan_out=F`` warms up the chains, then clones each into F chains
    (:func:`fan_state`, on each process's block) and collects
    ``num_samples // F`` sampling iterations per clone — the total
    sampling work is unchanged but runs F-wide.  Returns ``(samples,
    extras, last_state)``: ``samples`` (frames, n_chains*F, d) and each
    extra field (frames, n_chains*F, ...), clone-major within each original
    chain, gathered over the mesh on every process (one all-reduce per
    field, the run's only collectives); ``last_state`` is the process's
    block, as JAX's is a sharded array."""
    if mesh is None:
        mesh = ChainMesh(generator.device if generator is not None
                         else process_device())
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not on this mesh of "
                         f"{mesh.size}")
    if generator is not None and generator.device != mesh.device:
        raise ValueError(f"the generator is on {generator.device}, the mesh "
                         f"on {mesh.device}")
    if mesh.size > 1 and generator is None:
        raise ValueError("a mesh of several processes needs a generator to "
                         "derive each rank's stream from")
    if num_samples % (thinning * fan_out):
        raise ValueError("num_samples must divide by thinning * fan_out")
    rows = chain_sharding(mesh, n_chains)
    if init_position is not None and mesh.size > 1:
        init_position = torch.as_tensor(init_position)
        if init_position.dim() == 2:
            init_position = init_position[rows]
    caller = generator
    if generator is not None:
        generator = rank_generator(generator, mesh.rank)
    num_collect = num_samples // thinning // fan_out
    fields = (kernel.sample_field, *extra_fields)
    state = init_state if init_state is not None else kernel.init(
        generator, n_chains=rows.stop - rows.start, position=init_position,
        device=mesh.device)
    advance = advancer(kernel, generator, state, thinning, eager)
    cap = max_steps_per_call or max(num_warmup + num_samples, 1)
    done = 0
    while done < num_warmup:
        todo = min(cap, num_warmup - done)
        with profiling.span("run_mcmc_sharded.warmup", steps=todo):
            state = advance(state, todo)
        done += todo

    if fan_out > 1:
        state = fan_state(state, fan_out)
        advance = advancer(kernel, generator, state, thinning, eager)

    frames_per_call = max(1, cap // thinning)
    chunks = []
    # no frame to collect: one empty chunk, the fields' empty frames
    for start in range(0, num_collect, frames_per_call) or (0,):
        todo = min(frames_per_call, num_collect - start)
        with profiling.span("run_mcmc_sharded.collect",
                            steps=todo * thinning):
            state, bufs = _collect(kernel, state, advance, todo, thinning,
                                   fields, generator, eager=eager)
        chunks.append(bufs)
    out = {f: torch.cat([c[f] for c in chunks]) if len(chunks) > 1
           else chunks[0][f] for f in fields}
    if generator is not caller:
        caller.set_state(generator.get_state())
    with profiling.span("run_mcmc_sharded.gather"):
        out = {f: gather_chains(v, mesh, dim=1) for f, v in out.items()}
    samples = out.pop(kernel.sample_field)
    return samples, out, state


# ---------------------------------------------------------------------------
# Collective diagnostics: per-process partial sums, reduced over the chain
# mesh (JAX: lax.psum over the chains mesh axis).
# ---------------------------------------------------------------------------

def _chain_sum(partial: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """The sum of a per-process partial over the mesh: an all-reduce in
    place, the identity on a mesh of one."""
    if mesh.size > 1:
        dist.all_reduce(partial, group=mesh.group)
    return partial


def _local(x: torch.Tensor, mesh: Optional[ChainMesh]):
    if mesh is None:
        return x, ChainMesh(x.device)
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not on this mesh of "
                         f"{mesh.size}")
    return x.to(mesh.device), mesh


def cross_chain_moments(x: torch.Tensor, mesh: Optional[ChainMesh] = None):
    """Global (mean, var) over the chain axis of a (C, ...) tensor without
    gathering: ``x`` is this process's block of the chains (JAX: the global
    sharded array), reduced by per-process partial sums + one all-reduce
    each over ``mesh`` (:func:`chain_mesh`; by default this process alone,
    on ``x``'s device)."""
    x, mesh = _local(x, mesh)
    n = _chain_sum(torch.tensor(float(x.shape[0]), device=x.device), mesh)
    s = _chain_sum(torch.sum(x, dim=0), mesh)
    s2 = _chain_sum(torch.sum(x * x, dim=0), mesh)
    mean = s / n
    var = s2 / n - mean * mean
    return mean, var


def sharded_gelman_rubin(samples: torch.Tensor,
                         mesh: Optional[ChainMesh] = None):
    """Split-R̂ of (draws, chains, ...) samples with this process's block of
    the chains: per-chain means and variances where the chains live, then
    all-reduces of O(params) numbers over ``mesh``, never of the draws."""
    x, mesh = _local(samples, mesh)
    half = x.shape[0] // 2
    x = torch.cat([x[:half], x[half:2 * half]], dim=1)
    n = x.shape[0]
    cm = torch.mean(x, dim=0)
    cv = torch.var(x, dim=0, correction=1)
    m = _chain_sum(torch.tensor(float(x.shape[1]), device=x.device), mesh)
    w = _chain_sum(torch.sum(cv, dim=0), mesh) / m
    mean_all = _chain_sum(torch.sum(cm, dim=0), mesh) / m
    b = n * _chain_sum(torch.sum((cm - mean_all) ** 2, dim=0),
                       mesh) / (m - 1.0)
    var_hat = (n - 1) / n * w + b / n
    return torch.sqrt(var_hat / w)
