"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with a
wrapper that launches it for CUDA tensors, a plain PyTorch version that the
wrapper runs for CPU tensors, and a launch counter:

* ``chol_update`` — K1, the batched rank-1 Cholesky update;
* ``arwmh_fused`` — K2, the fused ARWMH sweep;
* ``asss_fused`` — K3, the fused ASSS sweep.
"""

# The device potentials (csrc/common.cuh) each fused sweep is built for, by
# the tag a target builder sets (Target.device_potential) when its
# potential_fn is exactly that device function.  A target name alone does
# not say which potential is computed: diamonds(suff_stats=False) has the
# name of the sufficient-statistic form but no device twin.
DEVICE_POTENTIALS = {
    "fused ARWMH": ("eight_schools_noncentered", "eight_schools_centered",
                    "kidiq", "diamonds_ss"),
    "fused ASSS": ("eight_schools_noncentered", "eight_schools_centered",
                   "kidiq", "diamonds_ss"),
}


def check_device_potential(target, kernel: str) -> str:
    """The device-potential tag under which ``kernel`` ("fused ARWMH" or
    "fused ASSS") runs ``target``; raises ``NotImplementedError`` if the
    kernel has no device twin of ``target.potential_fn``."""
    tag = getattr(target, "device_potential", None)
    if tag not in DEVICE_POTENTIALS[kernel]:
        raise NotImplementedError(
            f"the {kernel} kernel has device potentials "
            f"{DEVICE_POTENTIALS[kernel]} only; target {target.name!r} has "
            f"device potential {tag!r}"
        )
    return tag
