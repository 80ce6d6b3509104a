"""Seconds of the exact-W column per set graded, over the timed window's
jobs: ``evaluate_run``'s own span (``timings["wasserstein"]``: the cost
matrices and the ε-auction, host clock closed by a synchronize)."""


def read(ctx):
    sets = ctx.window_work.get("sets", 0)
    if "wasserstein" not in ctx.window_spans or sets == 0:
        return None
    return ctx.window_spans["wasserstein"] / sets
