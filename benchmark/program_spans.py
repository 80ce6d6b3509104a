"""The program's own spans and counters, as the traced window left them in
the port's recorder (``adaptive_mcmc_tpu_torch.utils.profiling``).  The
recorder keeps spans only while a torch profiler runs, and the traced
window is the only time one runs in a benchmark process, so the spans kept
are the window's.  A program without the recorder has none: every reader
then returns None."""

from __future__ import annotations


def recorded():
    """The closed spans the program recorded, or None where it recorded
    none (or has no recorder)."""
    from adaptive_mcmc_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = [s for s in read() if s.end_ns is not None]
    return spans or None


def on_card(ctx) -> bool:
    """Whether the run's device is a CUDA card."""
    return str(ctx.device).startswith("cuda")


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def _within(spans, s, ancestor: str) -> bool:
    while s.parent is not None:
        s = spans[s.parent]
        if s.name == ancestor:
            return True
    return False


def seconds(spans, name: str, within=None) -> float:
    """Seconds in the spans of ``name`` (those inside a span of ``within``
    only, where given)."""
    return sum(s.seconds for s in spans if s.name == name
               and (within is None or _within(spans, s, within)))


def counted(spans, name: str):
    """The counter ``name`` over the outermost spans: every count taken
    inside a span."""
    return sum(s.counts.get(name, 0) for s in spans if s.parent is None)
