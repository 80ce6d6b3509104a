"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with a
wrapper that launches it for CUDA tensors, a plain PyTorch version that the
wrapper runs for CPU tensors, and a launch counter:

* ``chol_update`` — K1, the batched rank-1 Cholesky update;
* ``arwmh_fused`` — K2, the fused ARWMH sweep;
* ``asss_fused`` — K3, the fused ASSS sweep;
* ``auction`` — the ε-auction's round (``metrics/assignment.py``).

A wrapper adds one to its module's ``launches`` where it launches its kernel.
Nothing else writes a count, with one exception: a launch recorded into a
CUDA graph runs once per replay of that graph and not at capture, so whoever
captures one counts it so (:class:`CapturedLaunches`).
"""

import importlib

KERNEL_MODULES = ("chol_update", "arwmh_fused", "asss_fused", "auction")

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


def _kernel_module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """The launch count of every kernel module, by name."""
    return {n: _kernel_module(n).launches for n in KERNEL_MODULES}


class CapturedLaunches:
    """Launch counts of a CUDA graph.  ``with CapturedLaunches() as rec:``
    around the capture takes the launches the wrappers counted there, which
    did not run, off the counts again; ``rec.replayed()`` after each replay
    of the graph adds them, which did."""

    def __enter__(self):
        self._before = launch_counts()
        self._recorded = {}
        return self

    def __exit__(self, *exc):
        self._recorded = {n: c - self._before[n]
                          for n, c in launch_counts().items()}
        self._add(-1)
        return False

    def replayed(self) -> None:
        self._add(1)

    def _add(self, sign: int) -> None:
        for name, n in self._recorded.items():
            _kernel_module(name).launches += sign * n
