"""Operation counts shared by the kernel counts: one float operation per
add, multiply, division, square root or transcendental, as the
``csrc/common.cuh`` potentials do them."""

# one potential evaluation, by the port's target name
POTENTIAL_OPS = {
    "eight_schools": 142,         # 14 + 16 per school
    "diamonds": 830,              # 576 of them in u = Lᵀ(b − b̂)
}


def tri(d: int) -> int:
    return d * (d + 1) // 2


def rank1_ops(d: int) -> int:
    """The GGMS74-C1 rank-1 Cholesky update: 12 per column's scalars, 6
    per entry."""
    return 12 * d + 6 * tri(d)
