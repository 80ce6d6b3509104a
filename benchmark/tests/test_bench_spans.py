"""The per-layer metrics that read the program's own spans and counters
(``program_spans.py`` and its five readers), on a recorder filled by hand
under a CPU profiler: each returns its ratio, and None where the spans it
reads are absent; and a tiny traced CPU run of each cell, which reads
exactly the metrics a CPU trace can give."""

from __future__ import annotations

import time

import pytest
from conftest import run_cell

from benchmark.harness import Context
from benchmark.registry import ROOT, Registry

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402

NAMES = ("w_eval_write_s", "graph_capture_s.sample", "graph_capture_s.grade",
         "auction_rounds_per_set", "k3_iters_per_step")


def _ctx(sets=0, device="cpu") -> Context:
    reg = Registry(ROOT)
    ctx = Context(cell="t", config={}, traffic={}, seed=1,
                  device=torch.device(device), registry=reg)
    ctx.traced_work = {"sets": sets}
    return ctx


def _read(name: str, ctx) -> float:
    return Registry(ROOT).layer_metric(name).read(ctx)


def _record(fn) -> list:
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return profiling.spans()


def _pause():
    time.sleep(0.002)


def _sum(spans, name, cond=lambda s: True) -> float:
    return sum(s.seconds for s in spans if s.name == name and cond(s))


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(name, device):
    assert _read(name, _ctx(sets=16, device=device)) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_with_other_spans_only(name):
    def work():
        with profiling.span("something.else"):
            profiling.count("other")
    _record(work)
    assert _read(name, _ctx(sets=16)) is None


def test_w_eval_write_s():
    def job():
        with profiling.span("run_w_eval"):
            with profiling.span("run_w_eval.sample"):
                _pause()
            with profiling.span("run_w_eval.to_host"):
                _pause()
            with profiling.span("run_w_eval.save"):
                _pause()

    spans = _record(lambda: [job() for _ in range(3)])
    want = (_sum(spans, "run_w_eval.to_host")
            + _sum(spans, "run_w_eval.save")) / 3
    assert want >= 0.004
    assert _read("w_eval_write_s", _ctx()) == pytest.approx(want)


def test_graph_capture_s_sample():
    def run(captures):
        with profiling.span("MCMC.run"):
            for _ in range(captures):
                with profiling.span("graph.capture", label="arwmh.step"):
                    _pause()

    def work():
        run(1)
        run(2)
        with profiling.span("graph.capture"):   # outside MCMC.run
            _pause()

    spans = _record(work)
    inside = _sum(spans, "graph.capture", lambda s: s.parent is not None)
    assert _read("graph_capture_s.sample", _ctx()) == pytest.approx(
        inside / 2)
    _record(lambda: run(0))
    assert _read("graph_capture_s.sample", _ctx()) is None
    # on the card, runs that captured nothing read 0
    assert _read("graph_capture_s.sample", _ctx(device="cuda")) == 0.0


def test_graph_capture_s_grade_and_rounds_per_set():
    def solve(rounds):
        with profiling.span("auction.solve", B=8, n=625, warm=False):
            with profiling.span("auction.level", eps=1.0):
                with profiling.span("graph.capture", label="auction"):
                    _pause()
                profiling.count("auction.rounds", rounds)

    def work():
        with profiling.span("evaluate_run"):
            with profiling.span("evaluate.wasserstein"):
                solve(96)
                solve(32)
        with profiling.span("graph.capture"):   # not the auction's
            _pause()

    spans = _record(work)
    inside = _sum(spans, "graph.capture",
                  lambda s: s.parent is not None)
    assert _read("graph_capture_s.grade", _ctx(sets=16)) == pytest.approx(
        inside / 16)
    assert _read("auction_rounds_per_set", _ctx(sets=16)) == 128 / 16
    assert _read("auction_rounds_per_set", _ctx(sets=0)) is None


def test_graph_capture_s_grade_reads_0_on_the_card_without_captures():
    """Solves that replayed graphs kept from earlier ones: 0 on the card,
    None on the CPU (which captures nothing), None with no solve."""
    def work():
        with profiling.span("auction.solve", B=8, n=625, warm=True):
            profiling.count("auction.rounds", 32)

    _record(work)
    assert _read("graph_capture_s.grade", _ctx(sets=8, device="cuda")) \
        == 0.0
    assert _read("graph_capture_s.grade", _ctx(sets=8)) is None
    assert _read("graph_capture_s.grade", _ctx(sets=0, device="cuda")) \
        is None
    def no_solve():
        with profiling.span("evaluate_run"):
            _pause()

    _record(no_solve)
    assert _read("graph_capture_s.grade", _ctx(sets=8, device="cuda")) \
        is None


def test_k3_iters_per_step():
    def work():
        for iters in (1867, 1869):
            with profiling.span("run_w_eval"):
                profiling.count("k3.steps", 1000)
                profiling.count("k3.iters", torch.tensor(iters))

    _record(work)
    assert _read("k3_iters_per_step", _ctx()) == pytest.approx(1.868)


# the per-layer metrics a traced CPU run reads: no device metric (a CPU
# trace has no device operation), and of the program's spans and counters
# those the CPU records (it captures no CUDA graph and launches no K3)
ON_CPU = {
    "diamonds.asss_k3.w_eval100": {"w_eval_write_s"},
    "eight_schools_noncentered.arwmh_k1.c4096": set(),
    "diamonds.grade.exact_w": {"exact_w_s_per_set", "auction_rounds_per_set"},
    "diamonds.arwmh_k2.w_eval100": {"w_eval_write_s"},
}


@pytest.mark.parametrize("cell", sorted(ON_CPU))
def test_traced_cpu_run_reads_the_program(tiny_root, cell):
    reg = Registry(tiny_root)
    for m in reg.per_layer(cell):     # every reader of the cell resolves
        assert callable(reg.layer_metric(m["name"]).read)
    out = run_cell(tiny_root, cell, trace=1)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == ON_CPU[cell]
    assert all(m["value"] > 0 for m in out["metrics"].values())
