"""K1, the rank-1 Cholesky update (``csrc/chol_update.cu``), for C chains
at dimension d: the lower triangle of L, v and coef in (the update never
reads the upper triangle), the whole (d, d) factor of each chain out; 10
operations per column, 5 per entry."""

from benchmark.counts import common


def counts(C: int, d: int) -> tuple:
    """(bytes, operations) of one launch."""
    t = common.tri(d)
    return 4 * C * (t + d + 1 + d * d), C * (10 * d + 5 * t)
