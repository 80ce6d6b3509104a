"""Fixtures of the benchmark's tests: a copy of the benchmark in a
temporary directory, its cells cut to sizes the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each traffic mix at a size the CPU runs in a second or two
TINY = {
    "asss_k3.w_eval100": dict(chains=4, num_warmup=20, num_samples=40,
                              thinning=4, warm_budget=dict(num_warmup=4,
                                                           num_samples=8)),
    "arwmh_k2.w_eval100": dict(chains=4, num_warmup=20, num_samples=40,
                               thinning=4, warm_budget=dict(num_warmup=4,
                                                            num_samples=8)),
    "arwmh_k1.c4096": dict(chains=64, num_warmup=200, num_samples=200,
                           thinning=10),
    "grade.exact_w": dict(sets=4, draws=50, batch=2, check_sets=2),
}
# limits of the tiny cells where they differ from the cells': 200 steps
# of ARWMH leave the mean acceptance further from its target; 64 chains
# of 20 draws hold a law to a tenth of what 4096 chains of 100 do; and 60
# steps of diamonds do not reach the gold, so the tiny run checks the law
# only for its form
TINY_LIMITS = {
    "eight_schools_noncentered.arwmh_k1.c4096": {"accept_gap": 0.15,
                                                 "law_gap": 1.0},
    "diamonds.arwmh_k2.w_eval100": {"accept_gap": 0.15, "law_gap": 1e9},
    "diamonds.asss_k3.w_eval100": {"law_gap": 1e9},
}
GOLD_ROWS = 400


def copy_benchmark(dest: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """An unchanged copy of the benchmark."""
    return copy_benchmark(tmp_path)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark with every cell cut to a tiny size."""
    root = copy_benchmark(tmp_path)
    bench = root / "benchmark"
    for name, upd in TINY.items():
        p = bench / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(upd)
        p.write_text(json.dumps(t))
    gold = np.load(bench / "data" / "diamonds_gold.npy")[:GOLD_ROWS]
    np.save(bench / "data" / "tiny_gold.npy", gold)
    p = bench / "configs" / "diamonds.json"
    c = json.loads(p.read_text())
    c["gold"] = "tiny_gold.npy"
    p.write_text(json.dumps(c))
    for p in (bench / "limits").glob("*.json"):
        limits = json.loads(p.read_text())
        limits.update({k: v for k, v in TINY_LIMITS.get(p.stem, {}).items()
                       if k in limits})
        p.write_text(json.dumps(limits))
    return root


def run_cell(root: Path, workload: str, trace: int = 0, seed: int = 2**31 + 5,
             seconds: float = 0.2, capsys=None) -> dict:
    """One run of the harness on the CPU; its result line."""
    from benchmark import run

    class Out:
        line = ""

        def write(self, s):
            if s.strip():
                self.line = s

        def flush(self):
            pass

    out = Out()
    run.main(["--workload", workload, "--seed", str(seed), "--seconds",
              str(seconds), "--trace", str(trace)], root=root, device="cpu",
             stdout=out)
    return json.loads(out.line)
