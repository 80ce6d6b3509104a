"""The port's evaluate_run (adaptive_mcmc_tpu_torch.experiments.evaluate)
against the JAX package's on one seeded npz and one reference: every
column, the CSV read back by pandas, the host solver, checkpoint resume.

Tolerances: the metrics at rtol 1e-5 (tests/test_torch_metrics.py's), the
ESS columns at rtol 1e-4.  The auction's assignments are compared bit
for bit on the same cost matrices, seed after warm-started seed: its
arithmetic is exact.  The two packages' cost matrices round apart by an
ulp, and W is a float32 mean that XLA and PyTorch sum in different
orders, so W agrees at rtol 1e-6.  Everything runs on the CPU."""

import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu.experiments import evaluate as jev  # noqa: E402
from adaptive_mcmc_tpu.metrics.wasserstein import (  # noqa: E402
    minkowski_cost_matrix as jcost,
)
from adaptive_mcmc_tpu_torch.experiments import evaluate as tev  # noqa: E402
from adaptive_mcmc_tpu_torch.metrics import wasserstein as twass  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_experiments import _fake_run_npz  # noqa: E402

RTOL = 1e-5


@pytest.fixture(scope="module")
def run_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    npz = d / "w_eval" / "t" / "k.npz"
    _fake_run_npz(npz, n_seeds=6, n_draws=240, dim=3, rho=0.5)
    ref = np.random.default_rng(99).standard_normal((240, 3)) \
        .astype(np.float32)
    return d, npz, ref


@pytest.fixture(scope="module")
def jax_tables(run_npz):
    d, npz, ref = run_npz
    return {B: jev.evaluate_run(npz, ref, d / f"jax_{B}.csv",
                                exact_w_batch=B) for B in (1, 4)}


@pytest.mark.parametrize("B", [1, 4])
def test_evaluate_run_matches_jax(run_npz, jax_tables, B):
    d, npz, ref = run_npz
    want = jax_tables[B]
    got = tev.evaluate_run(npz, ref, d / f"port_{B}.csv", exact_w_batch=B,
                           device="cpu")
    assert tuple(got) == tuple(want.columns) == tev.COLUMNS
    np.testing.assert_array_equal(got["rng_seed"], want["rng_seed"])
    for c in ("rmse_means", "sinkhorn", "mmd"):
        np.testing.assert_allclose(got[c], want[c], rtol=RTOL, err_msg=c)
    np.testing.assert_allclose(got["wasserstein"], want["wasserstein"],
                               rtol=1e-6)
    for c in ("ess_median", "ess_min"):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_allclose(got[c], want[c], rtol=1e-4, err_msg=c)
    pt, pj = (pd.read_csv(d / f"{s}_{B}.csv") for s in ("port", "jax"))
    assert list(pt.columns) == list(pj.columns) and pt.shape == pj.shape
    pd.testing.assert_frame_equal(pt, pj, check_exact=False, rtol=1e-4)


def _recording(module, name, log):
    """``module.name`` wrapped to append each solve's row -> column
    assignment (as numpy) to ``log``."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        cols = out[0] if isinstance(out, tuple) else out
        log.append(np.array(cols))
        return out

    return wrapped


@pytest.mark.parametrize("B", [1, 4])
def test_auction_assignments_bit_for_bit_on_jax_costs(run_npz, monkeypatch,
                                                      B):
    """evaluate_run of both packages on JAX's cost matrices: every seed's
    auction (warm-started from the previous solve's prices) picks JAX's
    assignment, bit for bit; W, a float32 mean summed in another order,
    agrees at rtol 1e-6."""
    import importlib

    d, npz, ref = run_npz
    logs = {"jax": [], "port": []}
    for side, pkg in (("jax", "adaptive_mcmc_tpu"),
                      ("port", "adaptive_mcmc_tpu_torch")):
        w = importlib.import_module(f"{pkg}.metrics.wasserstein")
        a = importlib.import_module(f"{pkg}.metrics.assignment")
        monkeypatch.setattr(w, "auction_assignment",
                            _recording(w, "auction_assignment", logs[side]))
        monkeypatch.setattr(a, "auction_assignment_batch",
                            _recording(a, "auction_assignment_batch",
                                       logs[side]))
    monkeypatch.setattr(
        twass, "minkowski_cost_matrix",
        lambda u, v, ord=2.0: torch.from_numpy(np.array(jcost(
            jnp.asarray(u.numpy()), jnp.asarray(v.numpy()), ord=ord))))
    kw = dict(exact_w_batch=B, sinkhorn=False, hungarian_check_seeds=0)
    got = tev.evaluate_run(npz, ref, device="cpu", **kw)
    want = jev.evaluate_run(npz, ref, **kw)
    assert len(logs["port"]) == len(logs["jax"]) == (6 if B == 1 else 2)
    for a, b in zip(logs["port"], logs["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["wasserstein"], want["wasserstein"],
                               rtol=1e-6)


def test_csv_layout_is_to_csv(run_npz, jax_tables, tmp_path):
    """JAX's own table written by the port's writer gives the bytes of
    DataFrame.to_csv (float64 by repr, float32 by its shortest repr, NaN
    empty)."""
    df = jax_tables[1].copy()
    df.loc[2, "wasserstein"] = np.nan
    df.to_csv(tmp_path / "pandas.csv")
    tev.write_csv({c: df[c].to_numpy() for c in df.columns},
                  tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "pandas.csv").read_bytes()


def test_host_solver_matches_jax(run_npz):
    """The exact W by the host Hungarian (the spawn pool, 2 workers)."""
    d, npz, ref = run_npz
    got = tev.evaluate_run(npz, ref, exact_w_solver="host", n_workers=2,
                           exact_wasserstein_seeds=3, sinkhorn=False,
                           device="cpu")
    want = jev.evaluate_run(npz, ref, exact_w_solver="host", n_workers=1,
                            exact_wasserstein_seeds=3, sinkhorn=False)
    np.testing.assert_allclose(got["wasserstein"][:3],
                               want["wasserstein"][:3], rtol=1e-12)
    assert np.isnan(got["wasserstein"][3:]).all()


def test_checkpoint_resume_same_column(run_npz, tmp_path):
    """Killed after 4 of 6 seeds (a seed cap), then resumed, in both
    packages: the first 4 come from the checkpoint verbatim, the resumed
    column equals JAX's resumed column, and an uninterrupted run's within
    the auction's bound (the resumed batch starts cold)."""
    d, npz, ref = run_npz
    cols = {}
    for side, ev, kw in (("port", tev.evaluate_run, {"device": "cpu"}),
                         ("jax", jev.evaluate_run, {})):
        ck = tmp_path / f"wck_{side}.json"
        first = ev(npz, ref, exact_wasserstein_seeds=4, exact_w_batch=2,
                   sinkhorn=False, checkpoint=ck, hungarian_check_seeds=1,
                   **kw)
        assert len(json.loads(ck.read_text())["wass"]) == 4
        resumed = ev(npz, ref, exact_w_batch=2, sinkhorn=False,
                     checkpoint=ck, hungarian_check_seeds=0, **kw)
        np.testing.assert_array_equal(np.asarray(resumed["wasserstein"])[:4],
                                      np.asarray(first["wasserstein"])[:4])
        cols[side] = np.asarray(resumed["wasserstein"])
    np.testing.assert_allclose(cols["port"], cols["jax"], rtol=1e-6)
    whole = tev.evaluate_run(npz, ref, exact_w_batch=2, sinkhorn=False,
                             hungarian_check_seeds=0, device="cpu")
    span = float(np.linalg.norm(ref.max(0) - ref.min(0))) * 2
    np.testing.assert_allclose(cols["port"], whole["wasserstein"],
                               atol=span / 240)
