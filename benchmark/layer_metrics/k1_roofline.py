"""K1's share of its roofline in the traced window: the K1 launches in the
profiler's trace, each at the cell's (chains, d) (``counts/k1.py``,
``peaks.py``), over their device time, in percent."""

NAMES = ("chol_update_kernel", "chol_update_cl_kernel")


def read(ctx):
    from benchmark.peaks import bound_seconds

    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds(NAMES)
    launches = ctx.trace.kernel_count(NAMES)
    if seconds <= 0 or launches == 0:
        return None
    nbytes, ops = ctx.registry.counts("k1").counts(
        int(ctx.traffic["chains"]), int(ctx.config["dim"]))
    return 100.0 * launches * bound_seconds(nbytes, ops) / seconds
