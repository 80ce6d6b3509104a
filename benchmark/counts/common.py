"""Operation counts shared by the kernel counts: one float operation per
add, multiply, division, square root or transcendental, as the
``csrc/common.cuh`` potentials do them.

One potential evaluation of each target is counted in a file of its own,
``counts/targets/<target>.py`` for the port's target name, as
``POTENTIAL_OPS``: a new target adds that file and edits none."""

import functools
from pathlib import Path

from benchmark.registry import load_module

TARGETS = Path(__file__).resolve().parent / "targets"


@functools.lru_cache(maxsize=None)
def potential_ops(target: str) -> int:
    """Operations of one evaluation of ``target``'s potential (a missing
    file raises FileNotFoundError with its path)."""
    return load_module(TARGETS / f"{target}.py",
                       f"benchmark_counts_target_{target}").POTENTIAL_OPS


def tri(d: int) -> int:
    return d * (d + 1) // 2


def rank1_ops(d: int) -> int:
    """The GGMS74-C1 rank-1 Cholesky update: 12 per column's scalars, 6
    per entry."""
    return 12 * d + 6 * tri(d)
