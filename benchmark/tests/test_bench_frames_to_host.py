"""The reader of ``frames_to_host_s`` on a recorder filled by hand under a
CPU profiler: the ``run_mcmc.to_host`` seconds inside ``MCMC.run`` per
run, and None without that span (the CPU, or a program that lands no
frames on the host)."""

from __future__ import annotations

import time

import pytest

from benchmark.harness import Context
from benchmark.registry import ROOT, Registry

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402

REG = Registry(ROOT)


def _read(device="cpu"):
    ctx = Context(cell="kidiq.asss_k3.c4096", config={}, traffic={}, seed=1,
                  device=torch.device(device), registry=REG)
    return REG.layer_metric("frames_to_host_s").read(ctx)


def _record(fn) -> list:
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return profiling.spans()


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _run(landed=True):
    with profiling.span("MCMC.run"):
        with profiling.span("run_mcmc.warmup", steps=10):
            time.sleep(0.002)
        with profiling.span("run_mcmc.collect", steps=20, thinning=2):
            time.sleep(0.002)
            if landed:
                with profiling.span("run_mcmc.to_host"):
                    time.sleep(0.002)
                    profiling.count("run_mcmc.host_bytes", 64)


def test_frames_to_host_s_reads_the_copy_per_run():
    def work():
        _run()
        _run()
        _run(landed=False)
        with profiling.span("run_mcmc.to_host"):    # no MCMC.run
            time.sleep(0.002)

    spans = _record(work)
    inside = sum(s.seconds for s in spans if s.name == "run_mcmc.to_host"
                 and s.parent is not None)
    assert inside >= 0.004
    assert _read() == pytest.approx(inside / 3)
    assert _read("cuda") == pytest.approx(inside / 3)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_frames_to_host_s_silent_without_its_span(device):
    assert _read(device) is None                    # nothing recorded
    _record(lambda: _run(landed=False))             # the parent's program
    assert _read(device) is None
    _record(lambda: profiling.count("run_mcmc.host_bytes", 0))
    assert _read(device) is None
