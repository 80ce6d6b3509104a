"""A tiny CPU run of each job kind through the harness, with its
reference: the result line's form, and the numbers compared printed
beside their limits last on standard error."""

from __future__ import annotations

import json

import pytest
from conftest import run_cell

from benchmark import run

CELLS = ("diamonds.asss_k3.w_eval100",
         "eight_schools_noncentered.arwmh_k1.c4096",
         "diamonds.grade.exact_w",
         "diamonds.arwmh_k2.w_eval100")


def _form(out: dict, trace: int) -> None:
    assert list(out)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] == 0
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for k in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][k]) <= 10
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_checks(tiny_root, cell, capsys):
    out = run_cell(tiny_root, cell)
    _form(out, 0)
    assert out["correct"], out["checks"]
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    tail = err[-len(out["checks"]):]
    assert [line.split()[1] for line in tail] == list(out["checks"])
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


@pytest.mark.parametrize("cell", CELLS[1:3])
def test_traced_run(tiny_root, cell):
    out = run_cell(tiny_root, cell, trace=1)
    _form(out, 1)
    # a CPU trace has no device operation: no device metric is read
    assert out["metrics"].get("device_idle.sample") is None
    assert out["device"]["platform"] == "cpu"


def test_no_card_no_result(capsys):
    try:
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present")
    except ImportError:
        pass
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload(capsys):
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_same_seed_same_inputs(tiny_root):
    """The same seed gives the same draws (the sets and the chains' start
    from the seed alone)."""
    a = run_cell(tiny_root, "eight_schools_noncentered.arwmh_k1.c4096",
                 seed=3 * 2**31)
    b = run_cell(tiny_root, "eight_schools_noncentered.arwmh_k1.c4096",
                 seed=3 * 2**31)
    assert json.dumps(a["checks"]) == json.dumps(b["checks"])


def test_grade_pool_orders_the_same_work(tiny_root):
    """Every seed grades the same pool of draws, in its own order."""
    from benchmark.harness import Context
    from benchmark.registry import Registry

    reg = Registry(tiny_root)
    traffic = reg.traffic("grade.exact_w")
    jobs = []
    for seed in (5, 2**31 + 3):
        ctx = Context(cell="diamonds.grade.exact_w",
                      config=reg.config("diamonds"), traffic=traffic,
                      seed=seed, device="cpu", registry=reg)
        job = reg.job_module("grade").Job(ctx)
        jobs.append([job.pool_seed(k) for k in range(traffic["pool"])])
    assert sorted(jobs[0]) == sorted(jobs[1]) and jobs[0] != jobs[1]
    assert len(set(jobs[0])) == traffic["pool"]
