"""The kidiq configuration and its cell ``kidiq.asss_k3.c4096``, added as
files alone: its float64 reference pinned at 64 points, its operation
count against its derivation, the cell's metrics, the reader of
``run_mcmc_host_s`` on recorded spans, and a tiny CPU run of the cell
(correct, traced, its control and its faults failing)."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
from conftest import ROOT, run_cell

from benchmark import faults
from benchmark.counts import common
from benchmark.harness import Context
from benchmark.readings import readings
from benchmark.reference import potentials
from benchmark.registry import Registry

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402

REG = Registry(ROOT)
CELL = "kidiq.asss_k3.c4096"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

# U and Σ |terms| at 64 gold draws plus 0.01 N(0, 1), seed 20261018
PINNED_U = [
    1862.2461315474052, 1859.6352292073236, 1860.9574321640357,
    1859.9118191111918, 1862.9910561712047, 1859.259523045863,
    1859.7283630455686, 1860.0506523514307, 1865.2788897224355,
    1861.4582738392855, 1862.4314275274062, 1859.8174421269987,
    1859.884757240824, 1860.1209842423643, 1863.4831030585078,
    1859.7833556973583, 1865.1419769751453, 1863.0898758727747,
    1859.7564226009508, 1862.7311633268241, 1861.2485533338972,
    1860.7295470157053, 1859.2724069909243, 1863.2147360126173,
    1865.3396843165585, 1864.4982219256483, 1860.282153993212,
    1859.6773983665676, 1860.4673353371043, 1860.250193630102,
    1860.8718189885035, 1862.53053353535, 1860.3778078865143,
    1864.3408016379512, 1862.1426558045234, 1859.5064641982985,
    1863.762280019755, 1866.3088232400462, 1862.935222655323,
    1861.387149367206, 1863.9146124240901, 1862.7689646788454,
    1860.4885056760588, 1860.4428690190166, 1861.109821287554,
    1862.0575758325763, 1859.2392829281941, 1860.595660120316,
    1867.0379190522578, 1860.143481743855, 1859.2093052339933,
    1859.3195265840095, 1860.5175060650286, 1862.1912580015385,
    1859.44994279835, 1863.35332093478, 1865.7080910049904,
    1860.5434088972029, 1859.337788242586, 1859.80371700496,
    1865.8956423088455, 1860.9704488763796, 1859.9224789882069,
    1859.2088339766362]
PINNED_MAG = [
    1868.0097757178305, 1865.3078368001582, 1866.6829545665528,
    1865.6383701350267, 1868.5995311667323, 1864.9425568502393,
    1865.3766408694125, 1865.7166821472492, 1871.1900738588495,
    1867.061080586668, 1868.0287565000067, 1865.5107996377747,
    1865.5164884389471, 1865.8847169118258, 1869.0990800167592,
    1865.4754194485147, 1870.932184654731, 1868.9078029888612,
    1865.5294900140564, 1868.4467709552218, 1867.0308308906388,
    1866.4626851520695, 1864.9525331633647, 1868.950077011169,
    1871.1365712111906, 1870.2286577878392, 1865.9555865365242,
    1865.3872438058718, 1866.113224542429, 1865.9442737841455,
    1866.6655891576654, 1868.3940819433278, 1866.0592900000245,
    1870.111787491292, 1867.7979345864985, 1865.1874708914659,
    1869.5773724011185, 1872.0662996457659, 1868.796502036362,
    1867.1040585938083, 1869.6425221351894, 1868.5129327912196,
    1866.175199500185, 1866.1183288329312, 1866.8530172654234,
    1867.902834418914, 1864.904356371387, 1866.3290403954265,
    1872.6412472876639, 1865.8422680785677, 1864.8955850767134,
    1865.0664306518265, 1866.2130889438406, 1867.9461329043686,
    1865.20066253569, 1869.247906871485, 1871.3812843505643,
    1866.1957581597712, 1865.0160275149162, 1865.540229464394,
    1871.4356822373377, 1866.64529056614, 1865.6696890299172,
    1864.9038622190167]


def _points(cfg: dict) -> np.ndarray:
    rng = np.random.default_rng(20261018)
    gold = np.load(REG.bench / "data" / cfg["gold"])
    return gold[rng.choice(len(gold), 64, replace=False)] \
        + 0.01 * rng.standard_normal((64, cfg["dim"]))


def test_reference_potential_bit_for_bit():
    cfg = REG.config("kidiq")
    u, mag = potentials.potential(cfg, _points(cfg), magnitude=True)
    assert u.tolist() == PINNED_U
    assert mag.tolist() == PINNED_MAG


def test_potential_ops_by_their_derivation():
    """csrc/common.cuh Kidiq: exp, the half-Cauchy term (5) and log of
    sigma (7 in all); per row mu (4), z (2) and the term into its running
    sum (5); the 14 sums met in order (13); lp + sum and the negation."""
    n = REG.config("kidiq")["N"]
    assert common.potential_ops("kidiq") == 7 + 11 * n + 13 + 2 == 4796
    k3 = REG.counts("k3")
    one = k3.totals("kidiq", 4096, 4, 1, 4096 * 1000, 0, 1.0, 1302)
    two = k3.totals("kidiq", 4096, 4, 1, 4096 * 1000, 0, 2.0, 1302)
    assert two[1] - one[1] == 4096 * 1000 * (3 * 10 + 5 * 4 + 9 + 4796)


def test_configuration_and_cell_entries():
    (c,) = [c for c in SPEC["configs"] if c["name"] == "kidiq"]
    cfg = REG.config("kidiq")
    assert c["reduced"] == [] and c["source"] == cfg["source"]
    assert cfg["n_data"] == 3 * cfg["N"] and cfg["dim"] == 4
    gold = np.load(REG.bench / "data" / cfg["gold"])
    assert gold.shape == (cfg["gold_draws"], cfg["dim"])
    w = REG.workload(CELL)
    assert w["chips"] == 1 and w["config"] == "kidiq"
    for text in (c["why"], w["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    t = REG.traffic(w["traffic"])
    assert (t["driver"], t["kernel"], t["fused"], t["chains"]) == \
        ("mcmc", "asss", True, cfg["chains"])


def test_the_cells_metrics():
    assert {m["name"] for m in REG.end_to_end(CELL)} == {
        "chain_iters_per_s", "setup_s"}
    assert {m["name"] for m in REG.per_layer(CELL)} == {
        "k3_roofline", "k3_iters_per_step", "mfu.sample",
        "device_idle.sample", "run_mcmc_host_s"}
    (m,) = [m for m in SPEC["per_layer"] if m["name"] == "run_mcmc_host_s"]
    assert m["workloads"] == [CELL] and m["source"] == "program_span"


# -- run_mcmc_host_s on recorded spans --------------------------------------

def _read(device="cpu"):
    ctx = Context(cell=CELL, config={}, traffic={}, seed=1,
                  device=torch.device(device), registry=REG)
    return REG.layer_metric("run_mcmc_host_s").read(ctx)


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


def _run(phases=True):
    with profiling.span("MCMC.run"):
        time.sleep(0.002)
        if phases:
            with profiling.span("run_mcmc.warmup", steps=10):
                time.sleep(0.002)
            with profiling.span("run_mcmc.collect", steps=20, thinning=2):
                time.sleep(0.002)


def test_run_mcmc_host_s_reads_the_rest_of_each_run():
    spans = _record(lambda: [_run() for _ in range(3)])
    runs = [s for s in spans if s.name == "MCMC.run"]
    inner = sum(s.seconds for s in spans if s.name.startswith("run_mcmc."))
    want = (sum(s.seconds for s in runs) - inner) / 3
    assert want >= 0.002
    assert _read() == pytest.approx(want)
    assert _read("cuda") == pytest.approx(want)


def test_run_mcmc_host_s_silent_without_its_spans():
    assert _read() is None                      # nothing recorded
    _record(lambda: _run(phases=False))         # a program without phases
    assert _read() is None
    _record(lambda: profiling.count("k3.steps", 1))
    assert _read() is None


# -- the cell at a tiny size on the CPU --------------------------------------

TINY_TRAFFIC = dict(chains=16, num_warmup=200, num_samples=400, thinning=4,
                    keep_from=2, trace_seconds=0.1)


@pytest.fixture
def kidiq_root(tiny_root):
    """The tiny copy with this cell cut to 16 chains of 600 steps, its law
    checked for its form only (600 steps from Uniform(-2, 2) do not reach
    the posterior)."""
    bench = tiny_root / "benchmark"
    p = bench / "traffic" / "asss_k3.c4096.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), **TINY_TRAFFIC)))
    p = bench / "limits" / f"{CELL}.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), law_gap=1e9)))
    return tiny_root


def test_tiny_cell_is_correct(kidiq_root):
    out = run_cell(kidiq_root, CELL)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"pe_gap", "frozen_share", "clock_gap",
                                  "law_gap"}
    assert set(out["metrics"]) == {"chain_iters_per_s", "setup_s"}
    out = run_cell(kidiq_root, CELL, trace=1)
    # a CPU trace: no device metric, no K3 launch; the driver's spans
    assert set(out["metrics"]) == {"run_mcmc_host_s"}


def test_tiny_control_fails(kidiq_root):
    limits = json.loads((kidiq_root / "benchmark" / "limits" /
                         f"{CELL}.json").read_text())
    (row,) = readings(CELL, [2**31 + 11], jobs=1, root=kidiq_root,
                      device="cpu")
    assert all(row["numbers"][k] <= v for k, v in limits.items())
    for control in (row["control"], row["control_fp16"]):
        assert control["pe_gap"] > limits["pe_gap"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_tiny_fault_is_not_correct(kidiq_root, fault):
    with faults.sample_fault(fault):
        out = run_cell(kidiq_root, CELL)
    assert not out["correct"]
