"""Evidence-integrity checks over the port's committed sweep snapshot
(mcmc_runs/torch_h100/results_state.json, written by
``python -m adaptive_mcmc_tpu_torch.experiments.sweep`` on the card).

Every cell of the snapshot carries its scale; the cells that ran the full
w_eval budget (scale 1) are held to tests/test_evidence.py's rmse band:
at or under the reference's plus half the cell's own across-seed std
(REF_RMSE).  W and MMD are held nowhere: the one gold set both packages
share is diamonds' vendored PosteriorDB draws, and no diamonds cell of the
snapshot ran at scale 1; eight schools was graded against the port's own
NUTS run, the reference's rows against PosteriorDB's gold, and how far
the two gold sets move W and MMD is not measured (PERF.md).  Skips where
the snapshot is absent."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
STATE = REPO / "mcmc_runs" / "torch_h100" / "results_state.json"
FIELDS = ("scale", "fan_out", "driver", "wall", "rate", "rmse_mean",
          "rmse_std", "w_mean", "w_std", "mmd_mean", "mmd_std", "ess_med",
          "ess_per_sec", "card")


def _bands():
    spec = importlib.util.spec_from_file_location(
        "_jax_evidence", Path(__file__).resolve().parent / "test_evidence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CELLS, mod.REF_RMSE, mod.REF_W_MMD


CELLS, REF_RMSE, REF_W_MMD = _bands()


@pytest.fixture(scope="module")
def state():
    if not STATE.exists():
        pytest.skip("no port sweep snapshot in this checkout")
    return json.loads(STATE.read_text())


def _full(state, cells):
    return [c for c in cells if c in state and state[c]["scale"] == 1.0]


def test_every_cell_present_with_every_field(state):
    for cell in CELLS:
        assert cell in state, f"missing cell {cell}"
        row = state[cell]
        for f in FIELDS:
            assert row.get(f) is not None, (cell, f)
        for f in FIELDS[3:-1]:
            assert np.isfinite(row[f]), (cell, f, row[f])
        assert 0 < row["scale"] <= 1.0 and row["n_seeds"] == 100


def test_full_budget_rmse_at_or_better_than_reference(state):
    for cell in _full(state, REF_RMSE):
        got, ref = state[cell]["rmse_mean"], REF_RMSE[cell]
        assert got <= ref + 0.5 * state[cell]["rmse_std"], (cell, got, ref)


def test_eval_csvs_complete(state):
    import csv

    for cell in state:
        target, kernel = cell.split("|")
        path = STATE.parent / target / f"eval_{kernel}.csv"
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["", "rng_seed", "rmse_means", "wasserstein",
                           "sinkhorn", "mmd", "ess_median", "ess_min"]
        assert len(rows) == 1 + state[cell]["n_seeds"], cell
