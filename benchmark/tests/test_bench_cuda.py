"""On the card: each cell at its own size, in a process of its own, comes
out correct with a short window.  Run on a machine with a CUDA card:

    python -m pytest benchmark/tests/test_bench_cuda.py -o addopts="" -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
