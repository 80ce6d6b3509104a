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


def _add_cell(root, config: str, traffic: str, t: dict, limits: dict) -> str:
    """A cell of ``config`` under a new traffic mix ``t``, with its limits
    and BENCHMARK.json entries."""
    bench = root / "benchmark"
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(t))
    cell = f"{config}.{traffic}"
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": cell, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "a test's cell"})
    spec["end_to_end"][0]["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


def _k1_traffic(root) -> dict:
    return json.loads((root / "benchmark" / "traffic" / "arwmh_k1.c4096.json"
                       ).read_text())


def test_the_traffic_names_the_sampler(tiny_root, monkeypatch):
    """An ``mcmc`` traffic naming NUTS runs NUTS, its acceptance held to
    the traffic's target 0.8 (ARWMH's 0.234 would read some 0.5 off)."""
    import adaptive_mcmc_tpu_torch as amt

    t = _k1_traffic(tiny_root)
    del t["law"]
    t.update(kernel="nuts", accept_target=0.8, chains=8, num_warmup=50,
             num_samples=50, thinning=5)
    cell = _add_cell(tiny_root, "eight_schools_noncentered", "nuts.c8", t,
                     {"pe_gap": 1e-5, "frozen_share": 0.05, "clock_gap": 0,
                      "accept_gap": 0.3})
    built = []
    nuts = amt.nuts

    def recorded(*a, **k):
        built.append(nuts(*a, **k))
        return built[-1]

    monkeypatch.setattr(amt, "nuts", recorded)
    for name in ("arwmh", "asss", "sa"):
        monkeypatch.setattr(amt, name, None)
    out = run_cell(tiny_root, cell)
    assert built and all(k.name == "nuts" for k in built)
    assert isinstance(built[0].config, amt.NUTSConfig)
    assert built[0].config.num_warmup == 50
    assert out["correct"], out["checks"]


def test_unknown_kernel_raises(tiny_root):
    from benchmark.harness import Context
    from benchmark.registry import Registry

    t = dict(_k1_traffic(tiny_root), kernel="nope")
    reg = Registry(tiny_root)
    ctx = Context(cell="x", config=reg.config("eight_schools_noncentered"),
                  traffic=t, seed=1, device="cpu", registry=reg)
    with pytest.raises(ValueError, match="unknown kernel 'nope'"):
        reg.job_module("sample").Job(ctx).setup()


def test_no_accept_target_no_accept_gap(tiny_root):
    """Without the traffic's ``accept_target`` no ``accept_gap`` is
    computed, and a limit that names one reads it as missing (inf): the
    run is not correct."""
    import numpy as np

    from benchmark.reference import compare, potentials
    from benchmark.registry import Registry

    cfg = Registry(tiny_root).config("eight_schools_noncentered")
    x = np.random.default_rng(3).standard_normal((4, 2, 10))
    pe = potentials.potential(cfg, x.reshape(-1, 10)).reshape(4, 2)
    o = {"x": x, "pe": pe, "x_last": x[:, -1], "pe_last": pe[:, -1],
         "i": 2, "map": np.array([0.1, 0.2, 0.3, 0.5])}
    t = {"num_warmup": 1, "num_samples": 1}
    assert "accept_gap" not in compare.sample_numbers([o], cfg, t)
    got = compare.sample_numbers([o], cfg, dict(t, accept_target=0.234))
    assert got["accept_gap"] == pytest.approx(0.25 - 0.234)

    t = _k1_traffic(tiny_root)
    del t["accept_target"]
    cell = _add_cell(tiny_root, "eight_schools_noncentered", "arwmh_k1.bare",
                     t, json.loads((tiny_root / "benchmark" / "limits" /
                                    "eight_schools_noncentered.arwmh_k1"
                                    ".c4096.json").read_text()))
    out = run_cell(tiny_root, cell)
    assert out["checks"]["accept_gap"]["value"] == float("inf")
    assert not out["correct"]
