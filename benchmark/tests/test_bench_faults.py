"""The comparison fails where it should: the control (the reference's
potential or metrics in bfloat16 in the program's place) reads above the
limits the program meets, and a run with a fault planted in the program
underneath (faults.py) comes out not correct."""

from __future__ import annotations

import json

import pytest
from conftest import run_cell

from benchmark import faults
from benchmark.readings import readings

SAMPLE_CELLS = ("eight_schools_noncentered.arwmh_k1.c4096",
                "diamonds.asss_k3.w_eval100",
                "diamonds.arwmh_k2.w_eval100")
GRADE_CELL = "diamonds.grade.exact_w"


def _limits(root, cell) -> dict:
    return json.loads((root / "benchmark" / "limits" / f"{cell}.json")
                      .read_text())


@pytest.mark.parametrize("cell", SAMPLE_CELLS + (GRADE_CELL,))
def test_control_fails_where_the_program_passes(tiny_root, cell):
    limits = _limits(tiny_root, cell)
    (row,) = readings(cell, [2**31 + 11], jobs=1, root=tiny_root,
                      device="cpu")
    assert all(row["numbers"][k] <= v for k, v in limits.items())
    assert any(row["control"][k] > v for k, v in limits.items())


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", SAMPLE_CELLS[:2])
def test_sample_fault_is_not_correct(tiny_root, cell, fault):
    with faults.sample_fault(fault):
        out = run_cell(tiny_root, cell)
    assert not out["correct"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_grade_fault_is_not_correct(tiny_root, fault):
    with faults.grade_fault(fault):
        out = run_cell(tiny_root, GRADE_CELL)
    assert not out["correct"]
