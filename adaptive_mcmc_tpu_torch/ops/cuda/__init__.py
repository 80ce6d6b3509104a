"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with a
wrapper that launches it for CUDA tensors, a plain PyTorch version that the
wrapper runs for CPU tensors, and a launch counter:

* ``chol_update`` — K1, the batched rank-1 Cholesky update;
* ``arwmh_fused`` — K2, the fused ARWMH sweep;
* ``asss_fused`` — K3, the fused ASSS sweep.
"""

# targets with a __device__ potential in csrc/common.cuh, the only ones the
# fused sweeps K2 and K3 can run on the card
DEVICE_POTENTIALS = ("eight_schools_noncentered",)


def check_device_potential(target, kernel: str) -> None:
    """Raise ``NotImplementedError`` if ``kernel`` has no device potential
    for ``target``."""
    if target.name not in DEVICE_POTENTIALS:
        raise NotImplementedError(
            f"the {kernel} kernel has a device potential for "
            f"{DEVICE_POTENTIALS} only, not {target.name!r}"
        )
