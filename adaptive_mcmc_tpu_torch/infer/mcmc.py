"""MCMC driver (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/infer/mcmc.py``: ``run_mcmc`` runs the
warmup, then a thinned collection into preallocated ``(num_collect, C, ...)``
buffers, so the unthinned draws never exist in memory.  Kernels with a
``step_n`` driver (ASSS, fused ARWMH, NUTS) advance through it, and kernels
with a ``collect_n`` driver (ASSS, fused ARWMH, NUTS) record the frames
inside it instead; NUTS's machine replays blocks of its trips from a CUDA
graph on the card (``eager=True``, which every ``step_n`` / ``collect_n``
takes, asks for the Python loop over the same blocks).  Other kernels
advance by their lockstep ``step``: where JAX jits the loop, PyTorch runs
eagerly, so on a CUDA device ``run_mcmc`` captures a block of ``step``
calls into a CUDA graph and replays it (:class:`StepBlocks`; kernels that
declare ``graph_step``, ARWMH, RWM and SA), and elsewhere the loop over
steps is a Python loop.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from adaptive_mcmc_tpu_torch.ops.cuda import CapturedLaunches

Tensor = torch.Tensor

_KERNEL_FACTORIES: dict = {}
# kernels whose step_n / step take injected ``noise`` / ``unif`` draws
_NOISE_UNIF_KERNELS = ("arwmh", "rwm")
# the longest block of steps captured into one CUDA graph
MAX_GRAPH_STEPS = 64
# operators that read a device value on the host or make a shape that
# depends on data: a step that reaches one cannot be captured
_HOST_READS = ("aten._local_scalar_dense.", "aten.nonzero.",
               "aten.masked_select.", "aten.unique", "aten._unique")


def register_kernel_factory(name: str, factory: Callable) -> None:
    _KERNEL_FACTORIES[name] = factory


def map_state(fn, tree, *others):
    """``fn`` over the tensors of a state (a NamedTuple of tensors and
    NamedTuples) and of ``others`` of the same structure."""
    if isinstance(tree, Tensor):
        return fn(tree, *others)
    if isinstance(tree, tuple):
        parts = [map_state(fn, *leaves) for leaves in zip(tree, *others)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    raise TypeError(
        f"a state holds tensors only, got {type(tree).__name__}: a Python "
        f"number would keep its value at capture in every replay of a CUDA "
        f"graph, and has no place in a checkpoint")


class _HostRead(RuntimeError):
    pass


class _NoHostRead(TorchDispatchMode):
    """Raises where an operator reads a device value on the host (.item(),
    bool(tensor), int(tensor)) or makes a shape that depends on data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        masked = name.startswith("aten.index.Tensor") and any(
            isinstance(i, Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in args[1])
        if masked or name.startswith(_HOST_READS):
            raise _HostRead(f"{name} reads device data on the host")
        return func(*args, **(kwargs or {}))


def _capture_error(kernel, why) -> RuntimeError:
    """The refusal of a capture: ``kernel`` is the kernel whose ``step``
    was captured, or the label of what was (``"nuts.step_n"``)."""
    what = kernel if isinstance(kernel, str) else f"{kernel.name}.step"
    return RuntimeError(
        f"run_mcmc cannot capture {what} into a CUDA graph: "
        f"{why}.  A step whose potential_fn reads a value on the host "
        f"(.item(), bool(tensor), int(tensor)) or makes a shape that "
        f"depends on data runs only in the eager loop: pass eager=True to "
        f"run_mcmc or MCMC.run (or to a kernel's step_n / collect_n).")


def checked_step(kernel, state, generator):
    """``kernel.step(state, generator)``, run eagerly, refusing a step that
    reads device data on the host: that step cannot be captured.  On a
    refusal the generator is put back where it was.  Works on any device;
    on a CUDA device it is also the warm call a capture needs (it builds K1
    and creates the library handles)."""
    saved = None if generator is None else generator.get_state()
    try:
        with _NoHostRead():
            return kernel.step(state, generator)
    except _HostRead as e:
        if saved is not None:
            generator.set_state(saved)
        raise _capture_error(kernel, e) from e


def _on_card(state) -> bool:
    return all(t.is_cuda for t in state_tensors(state))


def state_tensors(state) -> list:
    """The tensors of a state, in field order."""
    out = []
    map_state(lambda t: out.append(t), state)
    return out


def _capture(run_block: Callable, generator, kernel) -> Callable:
    """Capture ``run_block()`` into a CUDA graph and return its replay.
    The generator is registered with the graph, so that every replay draws
    on from the generator's state as the eager calls would.  A kernel
    launch recorded at capture is counted once per replay instead."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    try:
        with CapturedLaunches() as recorded, torch.cuda.graph(graph):
            run_block()
    except Exception as e:
        raise _capture_error(kernel, e) from e

    def replay() -> None:
        graph.replay()
        recorded.replayed()

    return replay


class StepBlocks:
    """Blocks of ``kernel.step`` calls over static state buffers: the
    counterpart of the jitted ``fori_loop`` body of the JAX ``run_mcmc``.

    ``state`` is cloned into the buffers (the caller's stays untouched); a
    block runs ``block`` steps from the buffers and writes the result back
    into them, and is captured once into a CUDA graph and replayed.  The
    first step of all runs eagerly (:func:`checked_step`: it refuses a step
    that cannot be captured, and warms the card for the capture that
    follows it); after it ``advance(n)`` replays ``n // block`` blocks and
    runs the remaining steps eagerly over the same buffers.  ``self.state``
    is the current state; copy what must outlive the next ``advance``."""

    def __init__(self, kernel, generator, state, block: int):
        self.kernel, self.generator, self.block = kernel, generator, block
        self.state = map_state(torch.clone, state)
        self._replay = None

    def _steps(self, n: int, step=None) -> None:
        step = step or self.kernel.step
        s = self.state
        for _ in range(n):
            s = step(s, self.generator)
        map_state(lambda dst, src: dst if dst is src else dst.copy_(src),
                     self.state, s)

    def advance(self, n: int):
        if self._replay is None and n:
            self._steps(1, lambda s, g: checked_step(self.kernel, s, g))
            n -= 1
            self._replay = _capture(lambda: self._steps(self.block),
                                    self.generator, self.kernel)
        for _ in range(n // self.block):
            self._replay()
        if n % self.block:
            self._steps(n % self.block)
        return self.state


def advancer(kernel, generator, state, block: int, eager: bool = False):
    """``advance(state, n) -> state``: ``n`` steps of ``kernel`` as
    :func:`run_mcmc` takes them.  Through ``step_n`` where the kernel has
    one (passing it ``eager``); from a CUDA graph of ``block`` steps
    (:class:`StepBlocks`) where
    its ``step`` can be captured and ``state`` lies on the card, unless
    ``eager``; otherwise in a Python loop over ``step``.  Pass each call
    the state the previous one returned."""
    if kernel.step_n is not None:
        return lambda s, n: kernel.step_n(s, n, generator, eager=eager)
    if kernel.graph_step and not eager and _on_card(state):
        blocks = StepBlocks(kernel, generator, state, block)
        return lambda s, n: blocks.advance(n)

    def loop(s, n: int):
        for _ in range(n):
            s = kernel.step(s, generator)
        return s

    return loop


def run_mcmc(
    kernel,
    generator: Optional[torch.Generator],
    num_warmup: int,
    num_samples: int,
    *,
    thinning: int = 1,
    n_chains: int = 1,
    init_position=None,
    extra_fields: Sequence[str] = (),
    init_state=None,
    noise: Optional[Tensor] = None,
    unif: Optional[Tensor] = None,
    device=None,
    eager: bool = False,
):
    """Run ``num_warmup`` burn-in + ``num_samples`` sampling iterations.

    Returns ``(samples, extras, last_state)`` where ``samples`` has shape
    (num_samples // thinning, chains, dim) in *unconstrained* space and
    ``extras`` maps each requested state field to its thinned trajectory.
    ``noise`` (T, C, d) and ``unif`` (T, C), with T = num_warmup +
    num_samples, replace the generator's draws step for step; only ARWMH
    and RWM take them (ASSS replays go through its ``step``).

    The run is on the device of the state, which follows the generator's
    (``Target.init_position``): a CUDA generator puts it on the card.
    There, a kernel without ``step_n`` whose ``step`` can be captured
    (``Kernel.graph_step``) runs its steps from a CUDA graph, with the draws
    of the eager loop, and NUTS's ``step_n`` / ``collect_n`` its machine's
    blocks of trips; ``init_state`` is never written.  A step that cannot
    be captured after all raises.  ``eager=True`` asks for the Python loop
    instead; a CPU run and a run with injected draws always take it.
    """
    if num_samples % thinning:
        raise ValueError("num_samples must divide by thinning")
    num_collect = num_samples // thinning
    sample_field = kernel.sample_field
    fields = (sample_field, *extra_fields)
    collect_n = kernel.collect_n
    if collect_n is not None and not set(fields) <= set(kernel.collect_fields):
        collect_n = None

    state = (
        kernel.init(generator, n_chains=n_chains, position=init_position,
                    device=device)
        if init_state is None else init_state
    )
    total = num_warmup + num_samples
    if (noise is None) != (unif is None):
        raise ValueError("pass both noise and unif, or neither")
    if noise is not None:
        if kernel.name not in _NOISE_UNIF_KERNELS:
            raise ValueError(
                f"run_mcmc replays injected noise/unif only for "
                f"{_NOISE_UNIF_KERNELS}; kernel {kernel.name!r} takes its "
                f"injected draws through its own step")
        if noise.shape[0] != total or unif.shape[0] != total:
            raise ValueError(f"injected draws must cover {total} steps")

    def draws(t0: int, n: int) -> tuple:
        if noise is None:
            return ()
        return noise[t0:t0 + n], unif[t0:t0 + n]

    if noise is None:
        steps = advancer(kernel, generator, state,
                         min(thinning, MAX_GRAPH_STEPS), eager)

        def advance(state, t0: int, n: int):
            return steps(state, n)
    else:
        def advance(state, t0: int, n: int):
            if kernel.step_n is not None:
                return kernel.step_n(state, n, generator, *draws(t0, n))
            for t in range(t0, t0 + n):
                state = kernel.step(state, generator, noise[t], unif[t])
            return state

    if num_warmup:
        state = advance(state, 0, num_warmup)

    if collect_n is not None and num_collect:
        state, bufs = collect_n(state, num_collect, thinning, generator,
                                *draws(num_warmup, num_samples), eager=eager)
        samples = bufs[sample_field].transpose(0, 1)
        extras = {f: bufs[f].transpose(0, 1) for f in extra_fields}
        return samples, extras, state

    bufs = {
        f: torch.empty((num_collect,) + tuple(getattr(state, f).shape),
                       dtype=getattr(state, f).dtype,
                       device=getattr(state, f).device)
        for f in fields
    }
    for k in range(num_collect):
        state = advance(state, num_warmup + k * thinning, thinning)
        for f in fields:
            bufs[f][k] = getattr(state, f)
    samples = bufs.pop(sample_field)
    return samples, bufs, state


class MCMC:
    """Convenience driver (``MCMC(kernel, num_warmup, num_samples,
    thinning, n_chains)`` -> ``.run(generator)`` -> ``.get_samples()`` /
    ``.print_summary()``), built on :func:`run_mcmc`."""

    def __init__(self, kernel, *, num_warmup: int, num_samples: int,
                 thinning: int = 1, n_chains: int = 1):
        self.kernel = kernel
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.thinning = thinning
        self.n_chains = n_chains
        self._samples = None
        self._extras = None
        self.last_state = None

    def run(self, generator: torch.Generator, *, init_position=None,
            extra_fields: Sequence[str] = (), device=None,
            eager: bool = False):
        # Rebuild the kernel with the driver's warmup count so the
        # adaptation clock resets at the warmup boundary.
        kernel = self.kernel
        if hasattr(kernel.config, "num_warmup") and (
            kernel.config.num_warmup != self.num_warmup
        ):
            factory = _KERNEL_FACTORIES.get(kernel.name)
            if factory is not None:
                cfg = dataclasses.replace(
                    kernel.config, num_warmup=self.num_warmup
                )
                kernel = factory(kernel.target, cfg)
                self.kernel = kernel
            elif getattr(kernel.config, "adapt", True):
                raise ValueError(
                    f"kernel {kernel.name!r} has no registered factory; "
                    f"build it with num_warmup={self.num_warmup} yourself"
                )
            # non-adaptive kernels (e.g. rwm): the warmup clock only
            # normalizes mean_accept_prob — safe to keep as built
        self._samples, self._extras, self.last_state = run_mcmc(
            kernel,
            generator,
            self.num_warmup,
            self.num_samples,
            thinning=self.thinning,
            n_chains=self.n_chains,
            init_position=init_position,
            extra_fields=extra_fields,
            device=device,
            eager=eager,
        )
        return self

    # -- accessors ------------------------------------------------------
    def get_samples(self, *, group_by_chain: bool = False,
                    flat_unconstrained: bool = False):
        """Constrained per-site samples; by default (draws, chains) are
        flattened into one leading axis."""
        if self._samples is None:
            raise RuntimeError("call .run() first")
        x = self._samples  # (T, C, d)
        if not group_by_chain:
            x = x.reshape((-1,) + tuple(x.shape[2:]))
        if flat_unconstrained:
            return x
        return self.kernel.target.constrain(x)

    def get_extra_fields(self):
        return self._extras

    def print_summary(self):
        from adaptive_mcmc_tpu_torch.infer.diagnostics import summary_table

        print(summary_table(self.kernel.target, self._samples))

    def diagnostics_str(self) -> str:
        """Progress diagnostics: the acceptance rate (and step size: ARWMH's
        λ, NUTS's dual-averaging ε) of states that carry them, otherwise
        the iteration and the mean potential energy (ASSS)."""
        s = self.last_state
        if hasattr(s, "mean_accept_prob"):
            ap = float(torch.mean(s.mean_accept_prob))
            a = getattr(s, "adapt_state", None)
            if hasattr(a, "log_step_size"):
                ss = float(torch.mean(torch.exp(a.log_step_size)))
            elif hasattr(a, "da"):
                ss = float(torch.mean(torch.exp(a.da.log_eps)))
            else:
                return f"Acceptance rate: {ap:.2f}"
            return f"Acceptance rate: {ap:.2f}, Step size: {ss:.3f}"
        return (f"Iteration: {int(s.i)}, Potential Energy: "
                f"{float(torch.mean(s.potential_energy)):.2f}")


# the rollouts of sample_pnx kept for their next call: (kernel, C, n,
# device, generator) -> _Rollout, the least recently used dropped first
_ROLLOUTS: OrderedDict = OrderedDict()
MAX_ROLLOUTS = 8


def _frozen(kernel):
    """``kernel`` rebuilt with adaptation off where its config adapts and
    its factory is registered (the rollout then skips the discarded
    adaptation), with every step pinning ``i`` and the adapt state (the
    reference's frozen semantics, for kernels with no such rebuild)."""
    if getattr(kernel.config, "adapt", False) \
            and kernel.name in _KERNEL_FACTORIES:
        changes = {"adapt": False}
        if getattr(kernel.config, "fused", None):
            changes["fused"] = None      # the fused drivers always adapt
        kernel = _KERNEL_FACTORIES[kernel.name](
            kernel.target, dataclasses.replace(kernel.config, **changes))
    step = kernel.step

    def pinned(state, generator):
        return step(state, generator)._replace(i=state.i,
                                               adapt_state=state.adapt_state)

    return dataclasses.replace(kernel, step=pinned)


class _Rollout:
    """A frozen kernel and, on the card for a kernel whose ``step`` can be
    captured, its CUDA graph of the pinned steps over static buffers; with
    the generator that seeded calls draw from."""

    def __init__(self, kernel, device, generator):
        self.kernel = _frozen(kernel)
        self.generator = torch.Generator(device)
        self.blocks: Optional[StepBlocks] = None
        self.refs = (kernel, generator)     # keeps the ids of the key alive


def _rollout(kernel, C: int, n: int, device, generator) -> _Rollout:
    key = (id(kernel), C, n, str(device),
           None if generator is None else id(generator))
    entry = _ROLLOUTS.pop(key, None)
    if entry is None:
        entry = _Rollout(kernel, device, generator)
    _ROLLOUTS[key] = entry
    while len(_ROLLOUTS) > MAX_ROLLOUTS:
        _ROLLOUTS.popitem(last=False)
    return entry


def sample_pnx(kernel, generator, x, adapt_state, *, n: int = 1,
               n_samples: int = 1000, eager: bool = False) -> Tensor:
    """Monte-Carlo sampler of the n-step transition kernel P^n(x, ·) at a
    frozen adapt state: the engine of the contraction diagnostics.

    ``x``: (n_points, d) probe points; returns (n_points, n_samples, d).
    The (points × samples) grid is flattened point-major into one chains
    axis of n_points * n_samples chains and rolled forward with the
    kernel's ``step``, ``i`` and the adapt state (each leaf of leading
    dimension 1 or n_points, broadcast over the grid) pinned after every
    step.

    ``generator`` is a ``torch.Generator``, whose draws continue from its
    state, or an int seed: calls with the same seed, shapes and kernel draw
    the same numbers, so two rollouts from nearby points are coupled
    (common random numbers).  With a seed, a kernel whose step draws a
    number of values that depends on the data (ASSS, NUTS) reseeds its
    generator from (seed, step) before every step, so that the coupling
    holds step by step, as JAX's per-chain keys do.  The run is on the
    generator's device, or for a seed on the device of ``x``.  On a CUDA
    device a kernel whose
    ``step`` can be captured (ARWMH, RWM, SA) replays its steps from a CUDA
    graph kept for the next call with the same kernel, chain count, ``n``
    and generator (or seed); ``eager=True`` asks for the Python loop, with
    the same draws.  ASSS and NUTS run their eager ``step``."""
    seeded = not isinstance(generator, torch.Generator)
    seed = int(generator) if seeded else None
    if seeded:
        device = x.device if isinstance(x, Tensor) else torch.device("cpu")
    else:
        device = generator.device
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    n_points, d = x.shape
    C = n_points * n_samples

    def grid(a: Tensor) -> Tensor:
        a = a.to(device)
        lead = a[:, None] if a.dim() >= 1 else a
        return lead.expand((n_points, n_samples) + tuple(a.shape[1:])) \
            .reshape((C,) + tuple(a.shape[1:]))

    adapt_b = map_state(grid, adapt_state)
    pos = x[:, None, :].expand(n_points, n_samples, d).reshape(C, d)
    entry = _rollout(kernel, C, n, device, None if seeded else generator)
    if seeded:
        generator = entry.generator.manual_seed(seed)
    frozen = entry.kernel
    state = frozen.init(generator, n_chains=C, position=pos,
                        adapt_state=adapt_b)
    if frozen.graph_step and not eager and device.type == "cuda" and n:
        if entry.blocks is None:
            entry.blocks = StepBlocks(frozen, generator, state,
                                      min(n, MAX_GRAPH_STEPS))
        else:
            map_state(lambda dst, src: dst.copy_(src), entry.blocks.state,
                      state)
        return entry.blocks.advance(n).position \
            .reshape(n_points, n_samples, d).clone()
    for t in range(n):
        if seeded and not frozen.graph_step:
            # a step whose draws depend on the data (ASSS's shrinkage trips,
            # NUTS's doublings) would shift every later step's draws of
            # one rollout against another's: each step starts afresh
            generator.manual_seed(hash((seed, t)) & (2**63 - 1))
        state = frozen.step(state, generator)
    return state.position.reshape(n_points, n_samples, d)


def get_init_adapt_state(kernel, generator, position=None,
                         n_chains: int = 1):
    """Adapt state right after init."""
    return kernel.init(generator, n_chains=n_chains,
                       position=position).adapt_state
