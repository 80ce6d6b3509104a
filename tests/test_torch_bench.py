"""The port's bench, entry() and profiling utilities on the CPU: the bench's
JSON line from given rates (five numeric cells, every ess_per_sec null,
valid JSON,
bench.py's fields), the bench and entry() refusing to run without a card,
entry(device="cpu") against the JAX entry(), and PhaseTimer, format_rate
and trace against adaptive_mcmc_tpu.utils."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as jentry  # noqa: E402
from adaptive_mcmc_tpu.utils import profiling as jprof  # noqa: E402
from adaptive_mcmc_tpu_torch import bench  # noqa: E402
from adaptive_mcmc_tpu_torch.entry import entry  # noqa: E402
from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402

RATES = {"arwmh": 27569412.71, "asss": 440000.04, "nuts": 123456.78,
         "asss_diamonds": 98765.43, "sa": 2161820.57}


def test_bench_json_line():
    line = json.dumps(bench.assemble(RATES, "NVIDIA H100 80GB HBM3, 700.00 W"))
    res = json.loads(line)
    assert res["metric"] == "arwmh_eight_schools_4096chains"
    assert res["value"] == 27569412.7
    assert res["vs_baseline"] == round(27569412.71 / 55_700.0, 2)
    assert res["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    cells = {c["metric"]: c for c in [res, *res["extras"]]}
    # bench.py's five cells, in its order
    assert list(cells) == [
        "arwmh_eight_schools_4096chains", "asss_eight_schools_4096chains",
        "nuts_eight_schools_1024chains", "asss_diamonds_1024chains",
        "sa_eight_schools_1024chains"]
    assert all(c["ess_per_sec"] is None for c in cells.values())
    assert all(c["unit"] == "chain_iters_per_sec" for c in cells.values())
    nuts = cells["nuts_eight_schools_1024chains"]
    assert nuts["value"] == 123456.8
    assert nuts["vs_baseline"] == round(123456.78 / 10_400.0, 2)
    assert all(isinstance(c["value"], float) for c in cells.values())
    sa = cells["sa_eight_schools_1024chains"]
    assert sa["vs_baseline"] == round(2161820.57 / 9_112.9, 2)
    assert "baseline_note" in sa
    assert cells["asss_diamonds_1024chains"]["vs_baseline"] == round(
        98765.43 / 3_672.0, 2)


def test_bench_and_entry_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    with pytest.raises(RuntimeError, match="card"):
        entry()


def test_entry_on_the_cpu_takes_one_finite_step():
    fn, (state,) = entry(device="cpu")
    jfn, (jstate,) = jentry.entry()
    assert tuple(state.position.shape) == np.shape(jstate.position) \
        == (256, 10)
    out = fn(state)
    assert int(out.i) == 1 and callable(jfn)
    assert bool(torch.isfinite(out.position).all())
    assert bool(torch.isfinite(out.adapt_state.scale).all())
    assert not out.position.is_cuda


def test_phase_timer_and_format_rate_match_jax():
    for args in ((1000, 4096, 0.5), (3, 1, 7.25), (10 ** 6, 1024, 123.4)):
        assert profiling.format_rate(*args) == jprof.format_rate(*args)
    timer, jtimer = profiling.PhaseTimer(device="cpu"), jprof.PhaseTimer()
    for t in (timer, jtimer):
        with t.phase("warm"):
            pass
        with t.phase("run"):
            pass
        with t.phase("warm"):
            pass
    assert list(timer.totals) == list(jtimer.totals) == ["warm", "run"]
    timer.totals = jtimer.totals = {"warm": 1.23456, "run": 0.5}
    assert timer.report() == jtimer.report() == "warm: 1.235s | run: 0.500s"


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        torch.ones(3).sum()
    with profiling.trace(str(tmp_path / "t")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list((tmp_path / "t").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
