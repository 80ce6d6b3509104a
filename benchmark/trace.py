"""The traced window: torch.profiler over whole jobs, reduced to device
busy time, kernel time by name, the top device operations and the longest
idle gaps with what the host was doing in them."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def _ns(event, what: str) -> int:
    # torch >= 2.1 gives start_ns/duration_ns, older releases only _us
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")()) * 1000


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [count, seconds]
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    n_device_events: int = 0

    def idle_share(self):
        if self.window_s <= 0 or self.n_device_events == 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def _match(self, patterns) -> list:
        return [v for k, v in self.kernels.items()
                if any(p in k for p in patterns)]

    def kernel_seconds(self, patterns) -> float:
        return sum(v[1] for v in self._match(patterns))

    def kernel_count(self, patterns) -> int:
        return sum(v[0] for v in self._match(patterns))


def _union(intervals: list) -> tuple:
    """Total length of a union of [start, end) intervals, and its pieces."""
    pieces = []
    for s, e in sorted(intervals):
        if pieces and s <= pieces[-1][1]:
            if e > pieces[-1][1]:
                pieces[-1][1] = e
        else:
            pieces.append([s, e])
    return sum(e - s for s, e in pieces), pieces


def _host_at(cpu: list, t: int) -> str:
    """The innermost host operation running at time ``t``."""
    best, width = "host idle", None
    for s, e, name in cpu:
        if s <= t < e and (width is None or e - s < width):
            best, width = name, e - s
    return best


def summarize(events, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    device, cpu, kernels = [], [], {}
    for ev in events:
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            device.append((start, start + dur))
            k = kernels.setdefault(ev.name(), [0, 0.0])
            k[0] += 1
            k[1] += dur * 1e-9
        elif dur > 0:
            cpu.append((start, start + dur, ev.name()))
    busy_ns, pieces = _union(device)
    gaps = sorted(((pieces[i + 1][0] - pieces[i][1], pieces[i][1])
                   for i in range(len(pieces) - 1)), reverse=True)[:top]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return TraceSummary(
        window_s=window_s,
        busy_s=busy_ns * 1e-9,
        kernels=kernels,
        device_ops=[[name, v[1]] for name, v in ops],
        idle_gaps=[[_host_at(cpu, t0 + g // 2), g * 1e-9] for g, t0 in gaps],
        n_device_events=len(device),
    )


def profile(fn) -> TraceSummary:
    """Run ``fn`` under torch.profiler; the trace's summary over the
    host-clock window, closed by a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return summarize(prof.profiler.kineto_results.events(), window)
