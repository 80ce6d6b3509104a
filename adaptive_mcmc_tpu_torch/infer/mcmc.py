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
declare ``graph_step``, ARWMH, RWM and SA), or the parts of a step whose
inner loop reads the host once per block of trips (:class:`LockstepGraph`;
kernels that declare ``step_parts``, ASSS), and elsewhere the loop over
steps is a Python loop.  Which of these collects a run's frames is decided
in one place (:func:`collector`), and :func:`_collect` is the one
collection, which ``parallel.run_mcmc_sharded`` runs in chunks.

:class:`MCMC` lands the draws it hands back in pinned host memory (one
copy, straight from the device frames, behind the collection); the sharded
driver, the checkpointed driver and the reference draws of
``experiments.evaluate`` keep the frames on the device that made them.

Spans and counters (``utils.profiling``): ``MCMC.run``; ``run_mcmc.warmup``
(attribute ``steps``) and ``run_mcmc.collect`` (``steps``, ``thinning``)
around :func:`run_mcmc`'s two phases, and in the latter
``run_mcmc.to_host`` around the copy of the frames to pinned host memory,
with its counter ``run_mcmc.host_bytes``; ``graph.capture``
around every capture (its ``label``: the kernel or machine);
``graph.replays``, per replay; ``host.reads``, the reads of a machine's
progress between blocks; ``rollouts.<device type>``, the frozen rollouts
of :func:`sample_pnx` by the device they ran on.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from adaptive_mcmc_tpu_torch.ops.cuda import CapturedLaunches
from adaptive_mcmc_tpu_torch.utils import profiling

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


def _label(kernel) -> str:
    """What is captured: the label given (``"nuts.step_n"``), or the
    kernel's ``step``."""
    return kernel if isinstance(kernel, str) else f"{kernel.name}.step"


def _capture_error(kernel, why) -> RuntimeError:
    """The refusal of a capture: ``kernel`` is the kernel whose ``step``
    was captured, or the label of what was (``"nuts.step_n"``)."""
    return RuntimeError(
        f"run_mcmc cannot capture {_label(kernel)} into a CUDA graph: "
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


def _capture(run_block: Callable, generator, kernel,
             pool=None) -> Callable:
    """Capture ``run_block()`` into a CUDA graph and return its replay.
    The generator is registered with the graph, so that every replay draws
    on from the generator's state as the eager calls would.  A kernel
    launch recorded at capture is counted once per replay instead.
    ``pool``: a memory pool shared with other graphs that write all they
    keep into buffers allocated outside them."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    shared = {} if pool is None else {"pool": pool}
    try:
        with profiling.span("graph.capture", label=_label(kernel)), \
                CapturedLaunches() as recorded, \
                torch.cuda.graph(graph, **shared):
            run_block()
    except Exception as e:
        raise _capture_error(kernel, e) from e

    def replay() -> None:
        graph.replay()
        recorded.replayed()
        profiling.count("graph.replays")

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


class BlockMachine:
    """A pipelined machine's driver (NUTS's trips, ASSS's iterations and
    its lockstep step's shrinkage trips): blocks of ``block`` steps until
    every chain is done, ``running`` read on the host between blocks.
    Eagerly (``run`` given no generator) a block is a Python loop over
    steps.  On the card the machine lives in static buffers: the first
    block runs eagerly under a mode that refuses host reads (a
    ``potential_fn`` that reads one cannot be captured), then one block is
    captured into a CUDA graph with the generator registered, and
    replayed; it draws what the eager blocks draw.  The call's constants
    (``n_steps``, the first iteration, the thinning) are tensors in the
    buffers, never numbers baked into the graph.  A call without frame
    buffers (``step_n``) keeps its graphs for the next one with the same
    shapes and generator.  A call with frames (``collect_n``) keeps none:
    its frame buffers are captured with it and handed back as they are, so
    none is copied or outlives the call.

    ``label`` names the machine in a refusal (``"nuts.step_n"``);
    ``frames`` are the keys of the frame buffers in ``ctx``; ``running(p,
    ctx)``, a host bool, is by default whether a chain's ``done`` is below
    ``n_steps``.  Each read of it counts ``host.reads``."""

    def __init__(self, label: str, frames: tuple, running=None):
        self.label, self.frames = label, frames
        self._running = running or self._done_below
        # (key, generator, p buffers, ctx buffers, replays, memory pool)
        self.cached = None

    @staticmethod
    def _done_below(p: dict, ctx: dict) -> bool:
        return bool((p["done"] < ctx["n_steps"]).any())

    def running(self, p: dict, ctx: dict) -> bool:
        profiling.count("host.reads")
        return self._running(p, ctx)

    def run(self, p: dict, ctx: dict, step, block: int, count,
            generator=None, saved=None, *, begin=None, end=None,
            repeat: int = 1, before=None):
        """Advance ``p`` to its end by ``step(p, ctx) -> p``; returns
        (p, ctx).  ``count(n)`` is told the steps of each block run.
        ``generator`` given: from the CUDA graph (the tensors are on the
        card); a refused first block puts the generator back to ``saved``,
        its state before the call.

        From the graph, with ``begin`` and ``end`` (each ``(p, ctx) ->
        p``): ``repeat`` rounds of ``before(t)`` (a host call, such as a
        reseed), ``begin``, the blocks until done, ``end``; ``begin``, one
        block and ``end`` are each captured once, into graphs that share
        one memory pool, and replayed (a lockstep step in parts,
        :class:`LockstepGraph`, whose kernel runs the eager rounds
        itself)."""
        parts = {"block": lambda q, c: _loop(step, block, q, c)}
        if begin is not None:
            parts["begin"] = begin
        if end is not None:
            parts["end"] = end
        if generator is None:
            while self.running(p, ctx):
                p = parts["block"](p, ctx)
                count(block)
            return p, ctx
        keep = not any(k in ctx for k in self.frames)
        key = (block, tuple(parts),
               tuple((k, tuple(t.shape), t.dtype, t.device)
                     for k, t in sorted(ctx.items())),
               tuple((k, tuple(t.shape), t.dtype)
                     for k in sorted(p) for t in state_tensors(p[k])))
        if keep and self.cached is not None and self.cached[0] == key \
                and self.cached[1] is generator:
            _, _, bp, bc, replays, pool = self.cached
            for k in p:
                map_state(lambda dst, src: dst.copy_(src), bp[k], p[k])
            for k in ctx:
                bc[k].copy_(ctx[k])
        else:
            bp = {k: map_state(torch.clone, v) for k, v in p.items()}
            bc = {k: v if k in self.frames else v.clone()
                  for k, v in ctx.items()}
            replays, pool = {}, torch.cuda.graph_pool_handle()
            if keep:
                self.cached = (key, generator, bp, bc, replays, pool)

        def run_part(name: str) -> None:
            if name in replays:
                replays[name]()
                return

            def run() -> None:
                q = parts[name](bp, bc)
                for k in bp:
                    map_state(lambda dst, src: dst if dst is src
                              else dst.copy_(src), bp[k], q[k])

            try:
                with _NoHostRead():
                    run()
            except _HostRead as e:
                generator.set_state(saved)
                raise _capture_error(self.label, e) from e
            replays[name] = _capture(run, generator, self.label, pool)

        for t in range(repeat):
            if before is not None:
                before(t)
            if begin is not None:
                run_part("begin")
            while self.running(bp, bc):
                run_part("block")
                count(block)
            if end is not None:
                run_part("end")
        if not keep:
            return bp, bc
        return ({k: map_state(torch.clone, v) for k, v in bp.items()},
                {k: v.clone() for k, v in bc.items()})


def _loop(step, n: int, p: dict, ctx: dict) -> dict:
    for _ in range(n):
        p = step(p, ctx)
    return p


class LockstepGraph:
    """A lockstep step given in parts (``Kernel.step_parts``: ASSS) from
    CUDA graphs on the card: the part before the loop, one block of
    ``parts.block()`` trips and the part after the loop, each captured once
    over static buffers with the generator registered
    (:class:`BlockMachine`), the active mask read on the host once per
    block.  The graphs are kept for the next ``advance`` with the same
    shapes; the draws are those of the kernel's eager ``step``, which runs
    the same blocks."""

    def __init__(self, parts, generator, label: str):
        self.parts, self.generator = parts, generator
        self.machine = BlockMachine(
            label, (), running=lambda p, ctx: bool(parts.running(p)))

    def advance(self, state, n: int, before=None) -> dict:
        """``n`` steps from ``state`` (left untouched); returns the step's
        dict, the new state under ``"s"``.  ``before(t)`` is called on the
        host before step t (a reseed of the generator)."""
        parts, g = self.parts, self.generator
        p, _ = self.machine.run(
            parts.work(state), {}, lambda q, c: parts.trip(q, g),
            parts.block(), parts.count, g, g.get_state(),
            begin=lambda q, c: parts.begin(q, g),
            end=lambda q, c: parts.end(q), repeat=n, before=before)
        return p


def advancer(kernel, generator, state, block: int, eager: bool = False):
    """``advance(state, n) -> state``: ``n`` steps of ``kernel`` as
    :func:`run_mcmc` takes them.  Through ``step_n`` where the kernel has
    one (passing it ``eager``); on the card, unless ``eager``, from a
    CUDA graph of ``block`` steps, at most ``MAX_GRAPH_STEPS`` (the
    drivers pass the thinning; :class:`StepBlocks`), where its ``step``
    can be captured, or from the graphs of its step's parts
    (:class:`LockstepGraph`) where it has ``step_parts``; otherwise in a
    Python loop over ``step``.  Pass each call
    the state the previous one returned."""
    if kernel.step_n is not None:
        return lambda s, n: kernel.step_n(s, n, generator, eager=eager)
    if kernel.step_parts is not None and not eager and _on_card(state):
        graph = LockstepGraph(kernel.step_parts, generator,
                              f"{kernel.name}.step")
        return lambda s, n: graph.advance(s, n)["s"]
    if kernel.graph_step and not eager and _on_card(state):
        blocks = StepBlocks(kernel, generator, state,
                            min(block, MAX_GRAPH_STEPS))
        return lambda s, n: blocks.advance(n)

    def loop(s, n: int):
        for _ in range(n):
            s = kernel.step(s, generator)
        return s

    return loop


def collector(kernel, fields: Sequence[str]) -> str:
    """How :func:`_collect` collects ``fields``: ``"collect_n"`` where the
    kernel buffers every one (ASSS, NUTS, fused ARWMH), otherwise the
    frame loop over its ``step_n`` (``"step_n"``) or ``step``
    (``"lockstep"``)."""
    if kernel.collect_n is not None \
            and set(fields) <= set(kernel.collect_fields):
        return "collect_n"
    return "lockstep" if kernel.step_n is None else "step_n"


def _collect(kernel, state, advance, n_frames: int, thinning: int,
             fields: Sequence[str], generator, draws: tuple = (),
             eager: bool = False):
    """``(state, {field: (n_frames, C, ...)})``: one ``collect_n`` call
    (given the injected ``draws``) where :func:`collector` says so,
    otherwise a frame of ``fields`` after each ``advance(state,
    thinning)``.  The collection of :func:`run_mcmc` and of each chunk of
    ``parallel.run_mcmc_sharded``."""
    if n_frames and collector(kernel, fields) == "collect_n":
        state, bufs = kernel.collect_n(state, n_frames, thinning, generator,
                                       *draws, eager=eager)
        # (C, F, ...) per chain -> (F, C, ...)
        return state, {f: bufs[f].transpose(0, 1) for f in fields}
    bufs = {f: getattr(state, f).new_empty(
        (n_frames, *getattr(state, f).shape)) for f in fields}
    for k in range(n_frames):
        state = advance(state, thinning)
        for f in fields:
            bufs[f][k] = getattr(state, f)
    return state, bufs


def _to_host(bufs: dict, fields: Sequence[str]) -> dict:
    """The frames ``bufs[f]`` of ``fields`` landed in pinned host memory,
    once the collection queued before this call has written them; CPU
    frames come back as they are.

    The host tensors take the frames' sizes and strides (``empty_like``:
    the frames are dense), so each field is one ``cudaMemcpyAsync`` of its
    whole storage on the run's stream, with no transpose on the card.
    They are allocated (from PyTorch's caching host allocator) while the
    collection still runs; the copy is issued once an event recorded
    behind the collection has completed, so that the ``run_mcmc.to_host``
    span times the copy alone."""
    frames = {f: bufs[f] for f in fields}
    first = frames[fields[0]]
    if not first.is_cuda:
        return bufs
    stream = torch.cuda.current_stream(first.device)
    collected = torch.cuda.Event()
    collected.record(stream)
    host = {f: torch.empty_like(t, device="cpu", pin_memory=True)
            for f, t in frames.items()}
    n_bytes = sum(t.numel() * t.element_size() for t in host.values())
    collected.synchronize()
    with profiling.span("run_mcmc.to_host"):
        for f, t in frames.items():
            host[f].copy_(t, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(stream)
        landed.synchronize()
        profiling.count("run_mcmc.host_bytes", n_bytes)
    return host


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
    to_host: bool = False,
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
    (``Kernel.graph_step``) runs its steps from a CUDA graph, one with
    ``step_parts`` (ASSS with ``step_n=None``) its step's parts, each with
    the draws of the eager loop, and NUTS's ``step_n`` / ``collect_n`` its
    machine's blocks of trips; ``init_state`` is never written.  A step
    that cannot be captured after all raises.  ``eager=True`` asks for the
    Python loop instead; a CPU run and a run with injected draws always
    take it.

    The frames are collected by :func:`_collect` (``collect_n`` where the
    kernel buffers every requested field, :func:`collector`).  They stay
    on the run's device, where the library's callers
    (``run_mcmc_checkpointed``, the reference draws of
    ``experiments.evaluate``) use them.  ``to_host=True``, which
    :meth:`MCMC.run` sets, lands the requested fields' frames in pinned
    host memory instead, inside the ``run_mcmc.collect`` span
    (:func:`_to_host`); a CPU run's frames are already there.
    ``last_state`` stays on the device either way.
    """
    if num_samples % thinning:
        raise ValueError("num_samples must divide by thinning")
    fields = (kernel.sample_field, *extra_fields)
    state = (
        kernel.init(generator, n_chains=n_chains, position=init_position,
                    device=device)
        if init_state is None else init_state
    )
    total = num_warmup + num_samples
    if (noise is None) != (unif is None):
        raise ValueError("pass both noise and unif, or neither")
    if noise is None:
        advance = advancer(kernel, generator, state, thinning, eager)
        draws = ()
    else:
        if kernel.name not in _NOISE_UNIF_KERNELS:
            raise ValueError(
                f"run_mcmc replays injected noise/unif only for "
                f"{_NOISE_UNIF_KERNELS}; kernel {kernel.name!r} takes its "
                f"injected draws through its own step")
        if noise.shape[0] != total or unif.shape[0] != total:
            raise ValueError(f"injected draws must cover {total} steps")
        t0 = 0

        def advance(state, n: int):
            # each call takes the next n steps' draws
            nonlocal t0
            t0 += n
            if kernel.step_n is not None:
                return kernel.step_n(state, n, generator, noise[t0 - n:t0],
                                     unif[t0 - n:t0])
            for t in range(t0 - n, t0):
                state = kernel.step(state, generator, noise[t], unif[t])
            return state

        draws = (noise[num_warmup:], unif[num_warmup:])

    if num_warmup:
        with profiling.span("run_mcmc.warmup", steps=num_warmup):
            state = advance(state, num_warmup)

    with profiling.span("run_mcmc.collect", steps=num_samples,
                        thinning=thinning):
        state, bufs = _collect(kernel, state, advance,
                               num_samples // thinning, thinning, fields,
                               generator, draws, eager)
        if to_host:
            bufs = _to_host(bufs, fields)
    samples = bufs.pop(kernel.sample_field)
    return samples, bufs, state


class MCMC:
    """Convenience driver (``MCMC(kernel, num_warmup, num_samples,
    thinning, n_chains)`` -> ``.run(generator)`` -> ``.get_samples()`` /
    ``.print_summary()``), built on :func:`run_mcmc`.

    A run on the card hands back its draws and extra fields in pinned host
    memory, copied once from the device frames behind the collection
    (``run_mcmc(..., to_host=True)``); ``last_state`` stays on the card."""

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

    @profiling.spanned("MCMC.run")
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
            to_host=True,
        )
        return self

    # -- accessors ------------------------------------------------------
    def get_samples(self, *, group_by_chain: bool = False,
                    flat_unconstrained: bool = False):
        """Constrained per-site samples; by default (draws, chains) are
        flattened into one leading axis.  They are host tensors (pinned
        after a run on the card): views of the draws :meth:`run` landed."""
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
        if getattr(kernel.config, "fused", False):
            # the fused drivers always adapt; the rollout steps by ``step``
            changes["fused"] = False
        kernel = _KERNEL_FACTORIES[kernel.name](
            kernel.target, dataclasses.replace(kernel.config, **changes))
    step = kernel.step

    def pinned(state, generator):
        return step(state, generator)._replace(i=state.i,
                                               adapt_state=state.adapt_state)

    parts = kernel.step_parts
    if parts is not None:
        end = parts.end

        def pinned_end(p):
            s = p["s"]
            q = end(p)
            return dict(q, s=q["s"]._replace(i=s.i,
                                             adapt_state=s.adapt_state))

        parts = parts._replace(end=pinned_end)
    return dataclasses.replace(kernel, step=pinned, step_parts=parts)


class _Rollout:
    """A frozen kernel and, on the card, the CUDA graphs of its pinned
    steps over static buffers (a kernel whose ``step`` can be captured) or
    of its step's parts (ASSS); with the generator that seeded calls draw
    from."""

    def __init__(self, kernel, device, generator):
        self.kernel = _frozen(kernel)
        self.generator = torch.Generator(device)
        self.blocks: Optional[StepBlocks] = None
        self.lockstep: Optional[LockstepGraph] = None
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
               n_samples: int = 1000, eager: bool = False,
               mesh=None) -> Tensor:
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
    graph, and ASSS its step's parts (:class:`LockstepGraph`, reseeded
    between the replays of two steps), each kept for the next call with
    the same kernel, chain count, ``n`` and generator (or seed);
    ``eager=True`` asks for the Python loop, with the same draws.  NUTS
    runs its eager ``step``.

    ``mesh`` (``parallel.chain_mesh``) splits the chains over its
    processes: the chain axis is padded to a multiple of the mesh size
    (the padding repeats the last chain), each process rolls its block on
    the mesh's device, and the blocks are gathered (one all-reduce) and
    the padding dropped, on every process.  Rank 0 draws as one process
    would; rank r > 0 from ``parallel.rank_seed(seed, r)`` for a seed
    (reseeding from it per step as above), or from
    ``parallel.rank_generator(generator, r)``, after which ``generator``
    takes that generator's final state.  Each block therefore equals a
    one-process ``sample_pnx`` of the block's chains as points
    (``n_samples=1``) from the rank's seed or generator."""
    seeded = not isinstance(generator, torch.Generator)
    if mesh is not None:
        device = mesh.device
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is not on this mesh of "
                             f"{mesh.size}")
        if not seeded and generator.device != device:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"mesh on {device}")
    elif seeded:
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
    if mesh is None or mesh.size == 1:
        return _rollout_positions(kernel, generator, pos, adapt_b, n,
                                  eager).reshape(n_points, n_samples, d)
    from adaptive_mcmc_tpu_torch.parallel import (
        chain_sharding,
        gather_chains,
        rank_generator,
        rank_seed,
    )

    padded = -(-C // mesh.size) * mesh.size
    rows = torch.arange(padded, device=device)[
        chain_sharding(mesh, padded)].clamp(max=C - 1)
    pos = pos[rows]
    adapt_b = map_state(lambda a: a[rows], adapt_b)
    if seeded:
        out = _rollout_positions(kernel, rank_seed(int(generator),
                                                   mesh.rank), pos,
                                 adapt_b, n, eager)
    else:
        own = rank_generator(generator, mesh.rank)
        out = _rollout_positions(kernel, own, pos, adapt_b, n, eager)
        if own is not generator:
            generator.set_state(own.get_state())
    return gather_chains(out, mesh)[:C].reshape(n_points, n_samples, d)


def _rollout_positions(kernel, generator, pos, adapt_b, n: int,
                       eager: bool) -> Tensor:
    """The frozen rollout of :func:`sample_pnx` from the chains ``pos``
    (C, d) under the adapt state ``adapt_b`` (each leaf (C, ...)): the
    positions after ``n`` steps.  ``generator`` is a ``torch.Generator``
    or an int seed."""
    seeded = not isinstance(generator, torch.Generator)
    seed = int(generator) if seeded else None
    device = pos.device
    profiling.count(f"rollouts.{device.type}")
    C = pos.shape[0]
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
        return entry.blocks.advance(n).position.clone()
    if frozen.step_parts is not None and not eager \
            and device.type == "cuda":
        if entry.lockstep is None:
            entry.lockstep = LockstepGraph(frozen.step_parts, generator,
                                           f"{frozen.name}.step")

        def reseed(t: int) -> None:
            generator.manual_seed(hash((seed, t)) & (2**63 - 1))

        return entry.lockstep.advance(state, n, reseed if seeded else None)[
            "s"].position
    for t in range(n):
        if seeded and not frozen.graph_step:
            # a step whose draws depend on the data (ASSS's shrinkage trips,
            # NUTS's doublings) would shift every later step's draws of
            # one rollout against another's: each step starts afresh
            generator.manual_seed(hash((seed, t)) & (2**63 - 1))
        state = frozen.step(state, generator)
    return state.position


def get_init_adapt_state(kernel, generator, position=None,
                         n_chains: int = 1):
    """Adapt state right after init."""
    return kernel.init(generator, n_chains=n_chains,
                       position=position).adapt_state
