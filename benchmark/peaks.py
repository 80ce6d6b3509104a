"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W limit): HBM bytes per second and float32 operations per second
outside the tensor cores.  The port computes in float32 with TF32 off and
uses no tensor core, so 67 TFLOP/s is its peak."""

PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time work that moves ``nbytes`` and does ``ops`` can
    take: the larger of its two bounds."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS)
