"""Phase timers and a torch.profiler trace (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/utils/profiling.py``: a runner wraps its
phases in :class:`PhaseTimer` (wall clock, synchronised with the card at
both edges so that asynchronous launches are counted where they run) and
its timed region in :func:`trace`, which writes a Chrome trace of the CPU
and CUDA activity (``chrome://tracing``, Perfetto or TensorBoard)."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase.  On a CUDA
    ``device`` each phase starts and ends with
    ``torch.cuda.synchronize(device)``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.totals: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
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
    nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def format_rate(iters: int, chains: int, seconds: float) -> str:
    total = iters * chains
    return (
        f"{total / seconds:,.0f} chain-iters/s "
        f"({iters / seconds:,.0f} it/s x {chains} chains)"
    )
