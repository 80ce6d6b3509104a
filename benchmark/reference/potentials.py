"""The posteriors' potentials (negative log densities, every normalising
constant kept) at rows of unconstrained points, computed from the raw data
in the dtype asked for: float64 for the reference, bfloat16 for the
control.

Each target's potential and the loader of its raw data lie in a file of
their own, ``reference/targets/<target>.py`` for the configuration's
``target``: ``raw(config) -> {name: float64 array}`` and ``potential(x,
config) -> (U, Σ|terms|)`` at the rows of ``x``, built from the helpers
here.  A new target adds that file and edits none."""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch

from benchmark.registry import load_module

DATA = Path(__file__).resolve().parents[1] / "data"
TARGETS = Path(__file__).resolve().parent / "targets"
LOG_2PI = math.log(2.0 * math.pi)


@functools.lru_cache(maxsize=None)
def _target(name: str):
    return load_module(TARGETS / f"{name}.py",
                       f"benchmark_reference_target_{name}")


def target(config: dict):
    """The module of the configuration's target,
    ``reference/targets/<target>.py``, loaded once (a missing file raises
    FileNotFoundError with its path)."""
    return _target(config["target"])


def normal(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * (z * z + LOG_2PI) - math.log(scale)


def student_t(x, df, loc, scale):
    z = (x - loc) / scale
    return (math.lgamma(0.5 * (df + 1)) - math.lgamma(0.5 * df)
            - 0.5 * math.log(df * math.pi) - math.log(scale)
            - 0.5 * (df + 1) * torch.log1p(z * z / df))


_CONST: dict = {}


def const(config: dict, x) -> dict:
    """The configuration's data, as float64 numpy arrays under ``"raw"``
    and as tensors in ``x``'s dtype and device, made once for each."""
    key = (config["target"], config.get("data_dir"), x.dtype, x.device)
    if key not in _CONST:
        raw = target(config).raw(config)
        _CONST[key] = {k: torch.tensor(v, device=x.device).to(x.dtype)
                       for k, v in raw.items()}
        _CONST[key]["raw"] = raw
    return _CONST[key]


def total(terms: list) -> tuple:
    """U = −Σ terms, and the magnitude Σ |terms| that sets its rounding
    (U itself can pass through 0 while its terms are large)."""
    u = terms[0]
    mag = torch.abs(terms[0])
    for t in terms[1:]:
        u = u + t
        mag = mag + torch.abs(torch.as_tensor(t))
    return -u, mag


def potential(config: dict, x: np.ndarray, dtype: str = "float64",
              block: int = 65536, magnitude: bool = False):
    """U at the rows of ``x`` (n, d), computed in ``dtype`` in blocks of
    rows, as float64; with ``magnitude`` also Σ |terms| of each."""
    dt = getattr(torch, dtype)
    fn = target(config).potential
    x = np.asarray(x)
    out = np.empty(x.shape[0], np.float64)
    mag = np.empty(x.shape[0], np.float64)
    for i in range(0, x.shape[0], block):
        xb = torch.as_tensor(x[i:i + block], dtype=torch.float64).to(dt)
        u, m = fn(xb, config)
        out[i:i + block] = u.to(torch.float64).numpy()
        mag[i:i + block] = m.to(torch.float64).numpy()
    return (out, mag) if magnitude else out
