"""One evaluation of the diamonds potential through its sufficient
statistics (``csrc/common.cuh``)."""

POTENTIAL_OPS = 830               # 576 of them in u = Lᵀ(b − b̂)
