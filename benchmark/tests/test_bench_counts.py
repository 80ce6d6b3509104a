"""The operation and byte counts at the cells' shapes, against the bounds
PERF.md's kernel table holds (copied from the port's chip_smoke.py)."""

from __future__ import annotations

import pytest
from conftest import ROOT

from benchmark.peaks import PEAK_BYTES, PEAK_FLOPS, bound_seconds
from benchmark.registry import Registry

REG = Registry(ROOT)


def test_k1_at_the_lockstep_cell():
    nbytes, ops = REG.counts("k1").counts(4096, 10)
    assert nbytes == 4 * 4096 * (55 + 10 + 1 + 100)
    assert ops == 4096 * (100 + 5 * 55)
    # 0.000812 ms by bytes (2.72 MB), PERF.md's K1 row
    assert bound_seconds(nbytes, ops) * 1e3 == pytest.approx(0.000812,
                                                             rel=1e-3)
    assert nbytes / PEAK_BYTES > ops / PEAK_FLOPS


def test_k2_at_the_w_eval_shape():
    k2 = REG.counts("k2")
    # 0.006636 µs a step by operations at (100, 26), PERF.md's w_eval row
    assert 100 * k2.step_ops("diamonds", 26) / PEAK_FLOPS * 1e6 == \
        pytest.approx(0.006636, rel=1e-3)
    nbytes, ops = k2.counts("diamonds", 100, 26, 110000, 100, 603)
    assert ops == 100 * (110000 * k2.step_ops("diamonds", 26)
                         + 101 * 5 * 351)
    assert ops / PEAK_FLOPS > nbytes / PEAK_BYTES


def test_k3_at_the_w_eval_shape():
    k3 = REG.counts("k3")
    one = k3.totals("diamonds", 100, 26, 1, 100 * 1000, 0, 1.0, 603)
    more = k3.totals("diamonds", 100, 26, 1, 100 * 1000, 0, 3.0, 603)
    # each further machine iteration reads 3 uniforms
    assert more[0] - one[0] == 4 * 3 * 100 * 2000
    assert more[1] - one[1] == 100 * 2000 * (3 * 351 + 5 * 26 + 9 + 830)


def test_k2_totals_add_up_launches():
    k2 = REG.counts("k2")
    one = k2.counts("diamonds", 100, 26, 1000, 10, 603)
    assert k2.totals("diamonds", 100, 26, 3, 3 * 100 * 1000, 3 * 100 * 10,
                     603) == (3 * one[0], 3 * one[1])


class _Trace:
    def __init__(self, seconds, count):
        self.seconds, self.count = seconds, count

    def kernel_seconds(self, names):
        return self.seconds

    def kernel_count(self, names):
        return self.count


@pytest.mark.parametrize("metric", ["k2_roofline", "k3_roofline"])
def test_roofline_reads_the_window_work(metric):
    class Ctx:
        registry = REG
        config = REG.config("diamonds")
        traffic = {"chains": 100, "evals_per_step": 2.5}
        traced_work = {"chain_iters": 100 * 55000, "draws": 100 * 100}
        trace = _Trace(1.0, 2)

    read = REG.layer_metric(metric).read
    assert 0 < read(Ctx) < 100
    Ctx.trace = _Trace(0.0, 0)            # the kernel off the path: silent
    assert read(Ctx) is None
    Ctx.trace, Ctx.traced_work = _Trace(1.0, 2), {}
    with pytest.raises(RuntimeError):     # in the trace, no work counted
        read(Ctx)


def test_lockstep_step_counts():
    step = REG.counts("arwmh_step")
    k2 = REG.counts("k2")
    assert step.step_ops("eight_schools", 10) == \
        k2.step_ops("eight_schools", 10) + 5 * 55

    class Ctx:
        traced_work = {"chain_iters": 4096 * 3000}
        config = {"target": "eight_schools", "dim": 10}

    assert step.window_ops(Ctx) == 4096 * 3000 * step.step_ops(
        "eight_schools", 10)
