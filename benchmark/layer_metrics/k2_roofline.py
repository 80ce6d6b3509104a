"""K2's share of its roofline in the traced window: the least time its
launches' work could take on the card (``counts/k2.py`` from the window's
chain-iterations and draws and the launches found in the trace;
``peaks.py``) over the device time of the K2 kernels, found by name in the
profiler's trace, in percent."""

NAMES = ("arwmh_rows_kernel", "arwmh_replicated_kernel")


def read(ctx):
    from benchmark.peaks import bound_seconds

    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds(NAMES)
    if seconds <= 0:
        return None
    if ctx.traced_work.get("chain_iters", 0) <= 0:
        raise RuntimeError("K2 ran in the traced window, but its jobs "
                           "counted no chain-iterations")
    nbytes, ops = ctx.registry.counts("k2").traced(
        ctx, ctx.trace.kernel_count(NAMES))
    return 100.0 * bound_seconds(nbytes, ops) / seconds
