"""Datasets for the PosteriorDB targets (numpy only).

Counterpart of ``adaptive_mcmc_tpu/models/data.py``, kept separate because
importing that module pulls JAX in through its package.  Data comes from
PosteriorDB when ``$MCMC_WORKDIR/posteriordb`` exists, and otherwise from
the vendored arrays.
"""

from __future__ import annotations

import json
import os
import zipfile
from functools import lru_cache
from pathlib import Path

import numpy as np


def _pdb_root() -> Path | None:
    wd = os.environ.get("MCMC_WORKDIR")
    if not wd:
        return None
    p = Path(wd) / "posteriordb" / "posterior_database"
    return p if p.exists() else None


def _pdb_data(dataset_name: str) -> dict | None:
    """Read a PosteriorDB data JSON (possibly zipped) without the
    posteriordb package."""
    root = _pdb_root()
    if root is None:
        return None
    base = root / "data" / "data"
    for cand in (base / f"{dataset_name}.json",
                 base / f"{dataset_name}.json.zip"):
        if cand.exists():
            if cand.suffix == ".zip":
                with zipfile.ZipFile(cand) as zf:
                    with zf.open(zf.namelist()[0]) as f:
                        return json.load(f)
            return json.loads(cand.read_text())
    return None


@lru_cache(maxsize=None)
def eight_schools() -> dict:
    """Rubin (1981) eight-schools data (y: treatment effects, sigma: SEs)."""
    d = _pdb_data("eight_schools")
    if d is not None:
        return {"y": np.asarray(d["y"], np.float32),
                "sigma": np.asarray(d["sigma"], np.float32)}
    return {
        "y": np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0],
                      np.float32),
        "sigma": np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0],
                          np.float32),
    }
