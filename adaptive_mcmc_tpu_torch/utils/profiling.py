"""The port's recorder of spans and counters, phase timers and a
torch.profiler trace (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/utils/profiling.py``: a runner wraps its
phases in :class:`PhaseTimer` (wall clock, synchronised with the card at
both edges so that asynchronous launches are counted where they run) and
its timed region in :func:`trace`, which writes a Chrome trace of the CPU
and CUDA activity (``chrome://tracing``, Perfetto or TensorBoard).

The program marks its layer boundaries with :func:`span` and counts its
work with :func:`count`.  Tracing is on while a torch profiler is active in
the process (any ``torch.profiler.profile`` session, :func:`trace`'s
included); there is no other switch.  With tracing off a span costs one
check and records nothing, and a count adds to the process totals only.
With tracing on a span is also a host event of its name in the profiler's
trace (a function-scope RecordFunction, :class:`_Open`), and is kept in
memory with its start and end on the profiler's clock (Unix-epoch
nanoseconds, ``time.time_ns``),
its parent, its attributes and the counts taken inside it.  Spans are kept
per thread.  No span or count belongs inside a region captured into a CUDA
graph (it would run once, at capture); counts are taken around captures
and replays, and per step or per round work is counted, never spanned.
:func:`spans` and :func:`totals` read the records, :func:`clear` empties
them."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

# whether a torch profiler is active in this process: the one check a span
# makes while tracing is off
tracing = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Span:
    """One recorded span: its name, its start and end in Unix-epoch
    nanoseconds (the clock of the profiler's events; ``end_ns`` is None
    while it is open), the index in :func:`spans` of the span it opened
    in, its attributes and the counts taken inside it, its children's
    included."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    attrs: dict
    counts: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Thread(threading.local):
    def __init__(self):
        self.spans: List[Span] = []     # counts: those taken in the span
        self.stack: List[int] = []      # indices of the open spans


_local = _Thread()
_totals: Dict[str, int] = {}
# counts given as device tensors, added on the device until they are read
_pending: Dict[str, torch.Tensor] = {}
_OFF = contextlib.nullcontext()


class _Open:
    """A span while tracing is on.  Its event in the profiler's trace is a
    function-scope RecordFunction (``_RecordFunctionFast``), not
    ``torch.profiler.record_function``: kineto draws a user-scope range
    that launched device work a second time on the device's timeline, as
    a device event as long as that work, which a measure of the device's
    busy time would count as busy."""

    __slots__ = ("name", "attrs", "fn", "record")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        local = _local
        self.record = Span(self.name, time.time_ns(), None,
                           local.stack[-1] if local.stack else None,
                           self.attrs, {})
        local.stack.append(len(local.spans))
        local.spans.append(self.record)
        self.fn = torch._C._profiler._RecordFunctionFast(self.name)
        self.fn.__enter__()
        return self.record

    def __exit__(self, *exc) -> bool:
        self.fn.__exit__(*exc)
        stack = _local.stack
        if stack and _local.spans[stack[-1]] is self.record:
            stack.pop()
        self.record.end_ns = time.time_ns()
        return False


def span(name: str, **attrs):
    """A context manager around one step of the program's work, recorded
    while tracing is on (a torch profiler is active); otherwise it does
    nothing."""
    if not tracing():
        return _OFF
    return _Open(name, attrs)


def spanned(name: str):
    """Decorate a function so that each call is a :func:`span` of
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _add(counts: dict, name: str, n) -> None:
    v = counts.get(name)
    counts[name] = n if v is None else v + n


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``: to the process totals always,
    and while tracing is on to the innermost open span.  ``n`` may be a
    device tensor: it is added on the device, with no host read, and
    turned into a number when the records are read."""
    if isinstance(n, torch.Tensor):
        _add(_pending, name, n)
    else:
        _totals[name] = _totals.get(name, 0) + n
    if _local.stack and tracing():
        _add(_local.spans[_local.stack[-1]].counts, name, n)


def _number(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def spans() -> List[Span]:
    """This thread's recorded spans, in the order they opened, each with
    the counts taken inside it and its children as host numbers."""
    out = [dataclasses.replace(s, counts={k: _number(v) for k, v in
                                          s.counts.items()})
           for s in _local.spans]
    for s in reversed(out):            # a child follows its parent
        if s.parent is not None:
            for k, v in s.counts.items():
                _add(out[s.parent].counts, k, v)
    return out


def totals() -> Dict[str, int]:
    """The process's counters since the last :func:`clear`."""
    for name in list(_pending):
        _add(_totals, name, _number(_pending.pop(name)))
    return dict(_totals)


def clear() -> None:
    """Forget this thread's spans and the process's counters."""
    _local.spans, _local.stack = [], []
    _totals.clear()
    _pending.clear()


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase.  On a CUDA
    ``device`` each phase starts and ends with
    ``torch.cuda.synchronize(device)``.  Each phase is also a
    :func:`span` of its name."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.totals: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            self._sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.totals[name] = self.totals.get(name, 0.0) + (
                    time.perf_counter() - t0
                )

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s" for k, v in self.totals.items())


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block, CPU and CUDA activities, written as a
    Chrome trace (``*.pt.trace.json``) into ``log_dir``; ``None`` traces
    nothing.  The recorder is cleared on entry, so :func:`spans` and
    :func:`totals` read the block's own afterwards."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def format_rate(iters: int, chains: int, seconds: float) -> str:
    total = iters * chains
    return (
        f"{total / seconds:,.0f} chain-iters/s "
        f"({iters / seconds:,.0f} it/s x {chains} chains)"
    )
