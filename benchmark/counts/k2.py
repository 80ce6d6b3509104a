"""K2, fused ARWMH (``csrc/arwmh_fused.cu``): one launch runs S steps of C
chains at dimension d and writes F frames.  State in (x, loc, the lower
triangle of L, pe, mean accept, log step) and out (x, loc, the whole L, pe,
mean accept, log step, as_change), the draws each step needs (d normals
and a uniform), the data in, the frames (position, pe, as_change) out.
Per step the proposal, the potential, the MH test, the running means and
the rank-1 update; as_change on each frame and on the last step."""

from benchmark.counts import common


def step_ops(target: str, d: int) -> int:
    """Operations of one chain's step."""
    return (3 * common.tri(d) + 2 * d) + common.POTENTIAL_OPS[target] + 15 \
        + 3 * d + common.rank1_ops(d)


def counts(target: str, C: int, d: int, S: int, F: int,
           n_data: int) -> tuple:
    """(bytes, operations) of one launch."""
    return totals(target, C, d, 1, C * S, C * F, n_data)


def totals(target: str, C: int, d: int, launches: int, chain_steps: int,
           chain_frames: int, n_data: int) -> tuple:
    """(bytes, operations) of ``launches`` launches of C chains that make
    ``chain_steps`` chain-steps and write ``chain_frames`` chain-frames in
    all."""
    t = common.tri(d)
    state_in, state_out = 2 * d + t + 3, 2 * d + d * d + 4
    nbytes = 4 * (launches * ((state_in + state_out) * C + n_data)
                  + chain_steps * (d + 1) + chain_frames * (d + 2))
    ops = chain_steps * step_ops(target, d) \
        + (chain_frames + launches * C) * 5 * t
    return nbytes, ops


def traced(ctx, launches: int) -> tuple:
    """(bytes, operations) of the traced window's K2 launches: its
    chain-iterations and draws, as the jobs count them."""
    cfg = ctx.config
    return totals(cfg["target"], int(ctx.traffic["chains"]), cfg["dim"],
                  launches, ctx.traced_work.get("chain_iters", 0),
                  ctx.traced_work.get("draws", 0), cfg["n_data"])


def window_ops(ctx) -> float:
    """The sampling step's operations in the traced window: K2 is the
    whole step (the per-launch terms left out)."""
    return traced(ctx, 0)[1]
