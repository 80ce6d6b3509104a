"""K3, fused ASSS (``csrc/asss_fused.cu``): one launch runs C chains at
dimension d until each has made its transitions, one potential evaluation
per machine iteration, and writes F frames.  State in (x, loc, the lower
triangle of S, pe, as) and out (x, loc, the whole S, pe, as, the iteration
count), the data in, the frames out; the draws the chains used: 3 uniforms
per iteration and d + 1 normals per transition.  Per iteration the inverse
map, the potential and the slice test; per landing the adaptation (rank-1
update, the sums of dloc and dS) and the next transition's projection and
velocity.

The iterations a transition needs depend on the chain's state.  They are
counted as the traffic's ``evals_per_step``: the mean over a whole job at
the cell's budget, read once and fixed, so that the count is the work the
cell's inputs need and does not follow what a kernel under test does."""

from benchmark.counts import common


def totals(target: str, C: int, d: int, launches: int, chain_steps: int,
           chain_frames: int, evals_per_step: float, n_data: int) -> tuple:
    """(bytes, operations) of ``launches`` launches of C chains that make
    ``chain_steps`` transitions at ``evals_per_step`` iterations each and
    write ``chain_frames`` chain-frames in all."""
    t = common.tri(d)
    iters = chain_steps * evals_per_step
    state_in, state_out = 2 * d + t + 2, 2 * d + d * d + 3
    nbytes = 4 * (launches * ((state_in + state_out) * C + n_data)
                  + 3 * iters + chain_steps * (d + 1)
                  + chain_frames * (d + 2))
    iteration = 3 * t + 5 * d + 9 + common.potential_ops(target)
    land = 6 * d + common.rank1_ops(d) + 3 * t + 3
    begin = 3 * d * (d - 1) // 2 + 14 * d + 18
    ops = (iters - launches * C) * iteration \
        + chain_steps * (land + begin)
    return nbytes, ops


def traced(ctx, launches: int) -> tuple:
    """(bytes, operations) of the traced window's K3 launches."""
    cfg, t = ctx.config, ctx.traffic
    return totals(cfg["target"], int(t["chains"]), cfg["dim"], launches,
                  ctx.traced_work.get("chain_iters", 0),
                  ctx.traced_work.get("draws", 0),
                  float(t["evals_per_step"]), cfg["n_data"])


def window_ops(ctx) -> float:
    """The sampling step's operations in the traced window: K3 is the
    whole step (the per-launch terms left out)."""
    return traced(ctx, 0)[1]
