"""The whole sampling step's share of the card's float32 peak in the
traced window: the operations the cell's chain-iterations need
(``counts/<traffic's step_count>.py``) over (the traced window × 67
TFLOP/s), in percent."""


def read(ctx):
    from benchmark.peaks import PEAK_FLOPS

    if ctx.trace is None or ctx.trace.n_device_events == 0:
        return None
    ops = ctx.registry.counts(ctx.traffic["step_count"]).window_ops(ctx)
    if ops <= 0:
        return None
    return 100.0 * ops / (ctx.trace.window_s * PEAK_FLOPS)
