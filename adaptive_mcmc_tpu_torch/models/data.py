"""Datasets for the PosteriorDB targets (numpy only).

Counterpart of ``adaptive_mcmc_tpu/models/data.py``, kept separate because
importing that module pulls JAX in through its package.  Data comes from
PosteriorDB when ``$MCMC_WORKDIR/posteriordb`` exists, and otherwise from
the vendored arrays and the same seeded generators as the JAX package
(equal bit for bit): the diamonds generator reads the sufficient statistics
from ``_data/``, the port's byte-for-byte copy of the JAX package's
``models/_diamonds_stats.npz``, beside the diamonds gold draws
(``_data/diamonds.npy``, a copy of its ``models/_gold/diamonds.npy``).
"""

from __future__ import annotations

import json
import os
import zipfile
from functools import lru_cache
from pathlib import Path

import numpy as np

# the port's vendored model data: the diamonds sufficient statistics and
# gold draws
DATA_DIR = Path(__file__).resolve().parent / "_data"


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


@lru_cache(maxsize=None)
def kidiq() -> dict:
    """kidiq (Gelman & Hill 2007): kid_score ~ mom_hs + mom_iq, N = 434.

    Synthetic fallback: kid_score = 26 + 6 mom_hs + 0.6 mom_iq + N(0, 18),
    mom_hs ~ Bernoulli(0.785), mom_iq ~ N(100, 15), the published fit.
    """
    d = _pdb_data("kidiq")
    if d is not None:
        return {k: np.asarray(d[k], np.float32)
                for k in ("kid_score", "mom_hs", "mom_iq")}
    rng = np.random.default_rng(20260816)
    n = 434
    mom_hs = (rng.random(n) < 0.785).astype(np.float32)
    mom_iq = (100.0 + 15.0 * rng.standard_normal(n)).astype(np.float32)
    kid_score = (26.0 + 6.0 * mom_hs + 0.6 * mom_iq
                 + 18.0 * rng.standard_normal(n)).astype(np.float32)
    return {"kid_score": kid_score, "mom_hs": mom_hs, "mom_iq": mom_iq}


@lru_cache(maxsize=None)
def diamonds() -> dict:
    """diamonds GLM (brms formulation): log(price) on 24 predictors,
    N = 5000.

    Fallback: a deterministic (X, Y) whose sufficient statistics (n, XcᵀXc,
    XcᵀYc, YcᵀYc, Ȳ) equal those recovered from the real data's gold draws
    (``_data/_diamonds_stats.npz``), so its posterior is the
    real one: a Gaussian linear regression's posterior depends on the data
    only through them.
    """
    d = _pdb_data("diamonds")
    if d is not None:
        return {"Y": np.asarray(d["Y"], np.float32),
                "X": np.asarray(d["X"], np.float32)}
    s = np.load(DATA_DIR / "_diamonds_stats.npz")
    A, c, yty, ybar, n = (
        s["A"], s["c"], float(s["yty"]), float(s["ybar"]), int(s["n"])
    )
    k = A.shape[0]
    rng = np.random.default_rng(20260817)
    # orthonormal frame U (n, k + 1), every column orthogonal to the ones
    # vector (QR of column-centered gaussians stays in the centered span)
    G = rng.standard_normal((n, k + 1))
    G -= G.mean(axis=0, keepdims=True)
    Q, _ = np.linalg.qr(G)
    U, u_res = Q[:, :k], Q[:, k]
    L = np.linalg.cholesky(A)
    Xc = U @ L.T                       # XcᵀXc = A exactly, column means 0
    beta_star = np.linalg.solve(A, c)
    r2 = yty - float(c @ beta_star)    # residual sum of squares
    if not r2 > 0:
        raise ValueError(f"diamonds statistics give a residual sum {r2}")
    Yc = Xc @ beta_star + np.sqrt(r2) * u_res
    X = np.concatenate([np.ones((n, 1)), Xc], axis=1)
    return {"Y": (ybar + Yc).astype(np.float32), "X": X.astype(np.float32)}
