"""The ARWMH lockstep step (``kernels/arwmh.py`` ``step``, K1 inside) of
one chain: the same algorithm as K2's step, with as_change on every step
(5 per entry of the factor).  The state in and out of each step stays on
the card between steps, so the whole step is counted by its operations."""

from benchmark.counts import k2


def step_ops(target: str, d: int) -> int:
    return k2.step_ops(target, d) + 5 * k2.common.tri(d)


def window_ops(ctx) -> float:
    """Operations of the chain-iterations run in the traced window."""
    return ctx.traced_work.get("chain_iters", 0) * step_ops(
        ctx.config["target"], ctx.config["dim"])
