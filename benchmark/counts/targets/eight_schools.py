"""One evaluation of the non-centered eight schools potential
(``csrc/common.cuh``)."""

POTENTIAL_OPS = 142               # 14 + 16 per school
