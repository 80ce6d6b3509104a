"""One evaluation of the kidiq potential (``csrc/common.cuh`` ``Kidiq``):
sigma = exp, the half-Cauchy term (5: the scale's multiply, a square,
log1p, a subtract, + log sigma), log sigma again (1); per row mu (4), z
(2) and the term added to its lane's running sum (5); the 14 lanes' sums
met in order (13), then lp + the sum and its negation (2)."""

POTENTIAL_OPS = 4796              # 22 + 11 per row at N = 434
