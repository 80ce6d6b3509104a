"""The port's recorder of spans and counters (adaptive_mcmc_tpu_torch.utils
.profiling) on the CPU: off without a profiler, spans that nest and roll
their counts up under one, on the clock of the profiler's own events, and
the spans and counters of run_w_eval, MCMC.run and evaluate_run with the
ε-auction.  The card's half (the device timeline, K3's counters) is in
tests/test_torch_cuda.py."""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments.configs import (  # noqa: E402
    w_eval_config,
)
from adaptive_mcmc_tpu_torch.experiments.evaluate import (  # noqa: E402
    evaluate_run,
)
from adaptive_mcmc_tpu_torch.experiments.runner import (  # noqa: E402
    run_w_eval,
)
from adaptive_mcmc_tpu_torch.ops.cuda.asss_fused import (  # noqa: E402
    GRAPH_ITERS,
)
from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402

MS = 1_000_000        # one millisecond in nanoseconds


def _traced(fn):
    """``fn()`` under a CPU torch.profiler, the recorder cleared first;
    returns (the recorded spans, the profiler's kineto events)."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return profiling.spans(), prof.profiler.kineto_results.events()


def _by_name(spans) -> dict:
    out = {}
    for i, s in enumerate(spans):
        out.setdefault(s.name, []).append(i)
    return out


def test_off_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a RecordFunction entered with tracing off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    profiling.clear()
    assert not profiling.tracing()
    with profiling.span("outer", a=1):
        with profiling.span("inner"):
            profiling.count("c", 3)
            profiling.count("c")
            profiling.count("d", torch.tensor(5))
    assert profiling.spans() == []
    assert profiling.totals() == {"c": 4, "d": 5}
    profiling.count("d", torch.tensor(2, dtype=torch.int64))
    assert profiling.totals()["d"] == 7
    profiling.clear()
    assert profiling.totals() == {}


def test_spans_nest_and_counts_roll_up():
    def work():
        with profiling.span("a", k=1):
            profiling.count("n")
            with profiling.span("b"):
                profiling.count("n", 2)
                profiling.count("t", torch.tensor(4))
            with profiling.span("c"):
                profiling.count("m")
                with profiling.span("d"):
                    profiling.count("m", 10)
        with profiling.span("e"):
            pass
        profiling.count("n", 100)        # outside every span

    spans, _ = _traced(work)
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [None, 0, 0, 2, None]
    assert spans[0].attrs == {"k": 1} and spans[1].attrs == {}
    assert spans[0].counts == {"n": 3, "t": 4, "m": 11}
    assert spans[1].counts == {"n": 2, "t": 4}
    assert spans[2].counts == {"m": 11} and spans[3].counts == {"m": 10}
    assert spans[4].counts == {}
    assert all(s.end_ns >= s.start_ns for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns \
        and spans[3].end_ns <= spans[2].end_ns <= spans[0].end_ns
    assert profiling.totals() == {"n": 103, "t": 4, "m": 11}


def test_spans_share_the_profilers_clock():
    """Each recorded span starts and ends within 1 ms of the kineto CPU
    event of its name: the spans are on the trace's clock."""
    def work():
        for name in ("first", "second"):
            with profiling.span(name):
                time.sleep(0.005)
                with profiling.span(f"{name}.inner"):
                    time.sleep(0.002)

    spans, events = _traced(work)
    kineto = {ev.name(): ev for ev in events
              if ev.name() in {s.name for s in spans}}
    assert len(kineto) == len(spans) == 4
    for s in spans:
        ev = kineto[s.name]
        start = ev.start_ns()
        end = start + ev.duration_ns()
        assert abs(start - s.start_ns) < MS, s.name
        assert abs(end - s.end_ns) < MS, s.name


def test_trace_clears_and_phase_timer_spans(tmp_path):
    profiling.count("before")
    timer = profiling.PhaseTimer(device="cpu")
    with profiling.trace(str(tmp_path / "t")):
        assert profiling.totals() == {}
        with timer.phase("warm"):
            profiling.count("x")
    assert [s.name for s in profiling.spans()] == ["warm"]
    assert profiling.spans()[0].counts == {"x": 1}
    assert list(timer.totals) == ["warm"]
    events = json.loads(next((tmp_path / "t").glob("*.pt.trace.json"))
                        .read_text())["traceEvents"]
    assert any(e.get("name") == "warm" for e in events)


def test_spanned_keeps_the_function():
    @profiling.spanned("f.call")
    def f(x, y=2):
        """doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc"
    spans, _ = _traced(lambda: f(1, y=3))
    assert [s.name for s in spans] == ["f.call"]
    assert f(1) == 3


def test_run_w_eval_records_its_tree(tmp_path):
    """run_w_eval on the CPU: the run_w_eval span with build, sample,
    to_host and save in it, and the sharded driver's chunks in sample,
    whose steps add up to warmup + samples."""
    W, N, seeds = 60, 200, 4
    rc = w_eval_config("eight_schools", "arwmh", num_warmup=W,
                       num_samples=N, thinning=10, n_seeds=seeds, seed0=3,
                       out_dir=str(tmp_path))
    spans, _ = _traced(lambda: run_w_eval(rc, verbose=False, device="cpu"))
    names = _by_name(spans)
    (root,) = names["run_w_eval"]
    assert spans[root].parent is None
    for child in ("build", "sample", "to_host", "save"):
        (i,) = names[f"run_w_eval.{child}"]
        assert spans[i].parent == root
    (sample,) = names["run_w_eval.sample"]
    for part in ("warmup", "collect", "gather"):
        for i in names[f"run_mcmc_sharded.{part}"]:
            assert spans[i].parent == sample
    order = [spans[i].name for i in range(len(spans))
             if spans[i].parent == root]
    assert order == ["run_w_eval.build", "run_w_eval.sample",
                     "run_w_eval.to_host", "run_w_eval.save"]
    steps = [spans[i].attrs["steps"] for part in ("warmup", "collect")
             for i in names[f"run_mcmc_sharded.{part}"]]
    assert sum(steps) == W + N


@pytest.mark.parametrize("kernel", ["arwmh", "asss"])
def test_mcmc_run_counts_chain_iters(kernel):
    """MCMC.run is a span, through the lockstep step (ARWMH) and through
    K3's plain version (ASSS), and the counts taken in it roll up to it:
    none for ARWMH on the CPU (no capture, no machine), the machine's
    iterations in whole blocks and its host reads for ASSS."""
    target = amt.eight_schools_noncentered()
    k = amt.arwmh(target, amt.ARWMHConfig(num_warmup=30)) \
        if kernel == "arwmh" else \
        amt.asss(target, amt.ASSSConfig(num_warmup=30, fused=True))
    mcmc = amt.MCMC(k, num_warmup=30, num_samples=40, thinning=4,
                    n_chains=6)
    spans, _ = _traced(lambda: mcmc.run(torch.Generator().manual_seed(1)))
    assert [s.name for s in spans if s.parent is None] == ["MCMC.run"]
    assert spans[0].counts == profiling.totals()
    if kernel == "arwmh":
        assert spans[0].counts == {}
    else:
        assert spans[0].counts["asss.machine_iters"] % GRAPH_ITERS == 0
        assert spans[0].counts["host.reads"] > 0


def test_evaluate_run_records_the_auction(tmp_path):
    """evaluate_run with the ε-auction: evaluate_run and one span per
    column, auction.solve (cold, then warm) and auction.level in the
    wasserstein column with their rounds, and timings["wasserstein"] the
    column span's seconds within 1 ms."""
    rng = np.random.default_rng(5)
    samples = rng.standard_normal((4, 120, 3)).astype(np.float32)
    npz = tmp_path / "run.npz"
    np.savez(npz, samples=samples, meta=json.dumps({"config": {}}))
    ref = rng.standard_normal((120, 3)).astype(np.float32) + 0.3
    timings = {}
    spans, _ = _traced(lambda: evaluate_run(
        npz, ref, exact_w_solver="auction", exact_w_batch=2,
        hungarian_check_seeds=0, sinkhorn=False, device="cpu",
        timings=timings))
    names = _by_name(spans)
    (root,) = names["evaluate_run"]
    columns = [s.name for s in spans if s.parent == root]
    assert columns == ["evaluate.rmse_means", "evaluate.mmd",
                       "evaluate.sinkhorn", "evaluate.wasserstein",
                       "evaluate.ess"]
    (wass,) = names["evaluate.wasserstein"]
    solves = names["auction.solve"]
    assert len(solves) == 2
    assert [spans[i].attrs for i in solves] == [
        {"B": 2, "n": 120, "warm": False}, {"B": 2, "n": 120, "warm": True}]
    for i in solves:
        assert spans[i].parent == wass
        assert spans[i].counts["auction.rounds"] > 0
        assert spans[i].counts["host.reads"] > 0
    levels = names["auction.level"]
    assert all(spans[i].parent in solves and "eps" in spans[i].attrs
               for i in levels)
    assert sum(spans[i].counts["auction.rounds"] for i in levels) \
        == spans[wass].counts["auction.rounds"] \
        == profiling.totals()["auction.rounds"]
    assert abs(timings["wasserstein"] - spans[wass].seconds) < 1e-3
    assert set(timings) == {"rmse_means", "mmd", "sinkhorn", "wasserstein",
                            "ess"}


@pytest.mark.parametrize("kernel", ["arwmh", "asss"])
def test_run_mcmc_records_its_phases(kernel):
    """run_mcmc's warmup and collection are spans inside MCMC.run, with
    their steps (and the thinning), through the lockstep loop (ARWMH) and
    through ``collect_n`` (ASSS, K3's plain version); the counts taken
    inside them roll up to MCMC.run."""
    target = amt.eight_schools_noncentered()
    k = amt.arwmh(target, amt.ARWMHConfig(num_warmup=30)) \
        if kernel == "arwmh" else \
        amt.asss(target, amt.ASSSConfig(num_warmup=30, fused=True))
    mcmc = amt.MCMC(k, num_warmup=30, num_samples=40, thinning=4,
                    n_chains=6)
    spans, _ = _traced(lambda: mcmc.run(torch.Generator().manual_seed(1)))
    names = _by_name(spans)
    (warm,), (collect,) = names["run_mcmc.warmup"], names["run_mcmc.collect"]
    assert spans[warm].parent == spans[collect].parent == 0
    assert spans[warm].attrs == {"steps": 30}
    assert spans[collect].attrs == {"steps": 40, "thinning": 4}
    assert spans[warm].end_ns <= spans[collect].start_ns
    assert spans[0].seconds >= spans[warm].seconds + spans[collect].seconds
    # a CPU run's frames are on the host already: nothing is copied
    assert "run_mcmc.to_host" not in names
    assert "run_mcmc.host_bytes" not in spans[0].counts
    if kernel == "asss":
        for i in (warm, collect):
            assert spans[i].counts["asss.machine_iters"] > 0
        assert spans[0].counts["asss.machine_iters"] == (
            spans[warm].counts["asss.machine_iters"]
            + spans[collect].counts["asss.machine_iters"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["arwmh", "asss"])
def test_run_mcmc_lands_its_frames_inside_collect(cuda, kernel):
    """On the card MCMC.run's copy of its frames to pinned host memory is
    one run_mcmc.to_host span inside run_mcmc.collect, after the
    collection (the lockstep loop, ARWMH; K3's collect_n, fused ASSS), its
    bytes those of the landed position and potential."""
    target = amt.eight_schools_noncentered()
    k = amt.arwmh(target, amt.ARWMHConfig(num_warmup=30)) \
        if kernel == "arwmh" else \
        amt.asss(target, amt.ASSSConfig(num_warmup=30, fused=True))
    mcmc = amt.MCMC(k, num_warmup=30, num_samples=40, thinning=4,
                    n_chains=64)
    mcmc.run(torch.Generator(cuda).manual_seed(1))      # builds and warms
    spans, _ = _traced(lambda: mcmc.run(
        torch.Generator(cuda).manual_seed(2),
        extra_fields=("potential_energy",)))
    names = _by_name(spans)
    (collect,), (landed,) = names["run_mcmc.collect"], \
        names["run_mcmc.to_host"]
    assert spans[landed].parent == collect
    assert spans[collect].end_ns >= spans[landed].end_ns
    n_bytes = 10 * 64 * (target.dim + 1) * 4
    assert spans[landed].attrs == {}
    assert spans[landed].counts == {"run_mcmc.host_bytes": n_bytes}
    assert spans[0].counts["run_mcmc.host_bytes"] == n_bytes
    assert mcmc.get_samples(group_by_chain=True,
                            flat_unconstrained=True).is_pinned()
