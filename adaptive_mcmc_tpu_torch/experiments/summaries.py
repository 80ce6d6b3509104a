"""Committable numeric summaries for the lr_decay trajectory family
(PyTorch port: the port's own copy of
``adaptive_mcmc_tpu/experiments/summaries.py``, numpy only, writing the same
bytes for the same npz).

The reference's lr-decay product is per-seed state trajectories pickled
under mcmc_runs (run_diamonds_lr_decay.py:67-68, collected via
utils/kernel_utils.py:20-38) that its notebooks reduce to adaptation-drift
and potential-energy plots.  Here the raw trajectory npz are multi-GB and
gitignored, so each (target, kernel, decay) cell additionally emits a
small per-log-grid-point CSV of across-seed statistics — the exact
sufficient statistics the figure layer (analysis/artifact_figures.py) and
the evidence-integrity tests (tests/test_evidence.py) consume.  These
CSVs are committed: a container wipe can delete the trajectories but not
the numbers behind the lr-decay claims.

Format: one header line, optional ``# key=value`` comment lines with run
provenance (n_seeds, wall), then one row per log-grid point with
across-seed mean / 5% / 50% / 95% quantiles of the ``as_change``
adaptation-drift diagnostic and the potential energy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

SUMMARY_COLUMNS = (
    "i",
    "as_change_mean", "as_change_q05", "as_change_q50", "as_change_q95",
    "pe_mean", "pe_q05", "pe_q50", "pe_q95",
)


def summary_path_for(npz_path: str | Path) -> Path:
    """decay_<tag>.npz -> summary_<tag>.csv (same cell directory)."""
    npz_path = Path(npz_path)
    tag = npz_path.stem.removeprefix("decay_")
    return npz_path.with_name(f"summary_{tag}.csv")


def write_lr_decay_summary(
    npz_path: str | Path, meta: Optional[Dict[str, object]] = None
) -> Path:
    """Reduce one trajectory npz to its committable summary CSV."""
    npz_path = Path(npz_path)
    with np.load(npz_path, allow_pickle=False) as d:
        i = np.asarray(d["i"]).astype(np.int64)            # (T,)
        ac = np.asarray(d["as_change"], dtype=np.float64)  # (T, seeds)
        pe = np.asarray(d["potential_energy"], dtype=np.float64)
    if ac.ndim == 1:  # single-chain runs: give them a seeds axis
        ac, pe = ac[:, None], pe[:, None]
    meta = dict(meta or {})
    meta.setdefault("n_seeds", ac.shape[1])

    def stats(a):
        q = np.quantile(a, [0.05, 0.5, 0.95], axis=1)
        return [a.mean(axis=1), q[0], q[1], q[2]]

    cols = [i.astype(np.float64)] + stats(ac) + stats(pe)
    out = summary_path_for(npz_path)
    with out.open("w") as f:
        for k, v in sorted(meta.items()):
            f.write(f"# {k}={v}\n")
        f.write(",".join(SUMMARY_COLUMNS) + "\n")
        for row in zip(*cols):
            f.write(f"{int(row[0])}," +
                    ",".join(f"{v:.8g}" for v in row[1:]) + "\n")
    return out


def read_lr_decay_summary(path: str | Path):
    """Load a summary CSV -> (meta dict, dict of column -> (T,) array).
    Returns None when the file is absent."""
    path = Path(path)
    if not path.exists():
        return None
    meta: Dict[str, str] = {}
    rows = []
    header = None
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            k, _, v = line[1:].strip().partition("=")
            meta[k.strip()] = v.strip()
        elif header is None:
            header = line.split(",")
        elif line:
            rows.append([float(x) for x in line.split(",")])
    data = np.asarray(rows, dtype=np.float64)
    assert header == list(SUMMARY_COLUMNS), header
    return meta, {c: data[:, j] for j, c in enumerate(header)}
