"""The posteriors' potentials (negative log densities, every normalising
constant kept) at rows of unconstrained points, computed from the raw data
in the dtype asked for: float64 for the reference, bfloat16 for the
control.

* eight schools, non-centered (PosteriorDB ``eight_schools_noncentered``):
  x = [mu, log tau, theta_base(8)]; mu ~ N(0, 5), tau ~ HalfCauchy(5),
  theta_base ~ N(0, 1), y_j ~ N(mu + tau theta_base_j, sigma_j), plus the
  Jacobian log tau.
* diamonds (PosteriorDB ``diamonds-diamonds``, brms): x = [Intercept,
  b(24), log sigma]; Intercept ~ StudentT(3, 8, 10), b ~ N(0, 1), sigma ~
  half StudentT(3, 0, 10), Y ~ N(Intercept + Xc b, sigma) with Xc the
  centred predictors, through the raw sufficient statistics (A = XcᵀXc,
  c = XcᵀYc, yty = YcᵀYc, ȳ, N): the residual sum is
  yty − 2 cᵀb + bᵀA b + N (Intercept − ȳ)², exact for this model."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parents[1] / "data"
LOG_2PI = math.log(2.0 * math.pi)


def _normal(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * (z * z + LOG_2PI) - math.log(scale)


def _student_t(x, df, loc, scale):
    z = (x - loc) / scale
    return (math.lgamma(0.5 * (df + 1)) - math.lgamma(0.5 * df)
            - 0.5 * math.log(df * math.pi) - math.log(scale)
            - 0.5 * (df + 1) * torch.log1p(z * z / df))


_CONST: dict = {}


def _raw(config: dict) -> dict:
    """The configuration's data as float64 numpy arrays."""
    if config["target"] == "diamonds":
        s = np.load(Path(config.get("data_dir", DATA)) / config["data"])
        return {k: np.asarray(s[k], np.float64)
                for k in ("A", "c", "yty", "ybar", "n")}
    return {k: np.asarray(config[k], np.float64) for k in ("y", "sigma")}


def _const(config: dict, x) -> dict:
    """The configuration's data, as float64 numpy arrays under ``"raw"``
    and as tensors in ``x``'s dtype and device, made once for each."""
    key = (config["target"], config.get("data_dir"), x.dtype, x.device)
    if key not in _CONST:
        raw = _raw(config)
        _CONST[key] = {k: torch.tensor(v, device=x.device).to(x.dtype)
                       for k, v in raw.items()}
        _CONST[key]["raw"] = raw
    return _CONST[key]


def eight_schools(x, config: dict):
    data = _const(config, x)
    y, sigma = data["y"], data["sigma"]
    mu, log_tau, tb = x[:, 0], x[:, 1], x[:, 2:]
    tau = torch.exp(log_tau)
    theta = mu[:, None] + tau[:, None] * tb
    z = (y - theta) / sigma
    terms = [_normal(mu, 0.0, 5.0),
             math.log(2.0 / (math.pi * 5.0)) - torch.log1p((tau / 5.0) ** 2),
             log_tau,
             torch.sum(-0.5 * (tb * tb + LOG_2PI), dim=1),
             torch.sum(-0.5 * (z * z + LOG_2PI) - torch.log(sigma), dim=1)]
    return _total(terms)


def diamonds(x, config: dict):
    data = _const(config, x)
    A, c, s = data["A"], data["c"], data["raw"]
    yty, ybar, n = float(s["yty"]), float(s["ybar"]), float(s["n"])
    a, b, log_sigma = x[:, 0], x[:, 1:-1], x[:, -1]
    sigma = torch.exp(log_sigma)
    sse = (yty - 2.0 * (b @ c) + torch.sum((b @ A) * b, dim=1)
           + n * (a - ybar) ** 2)
    terms = [_student_t(a, 3.0, 8.0, 10.0),
             torch.sum(-0.5 * (b * b + LOG_2PI), dim=1),
             math.log(2.0) + _student_t(sigma, 3.0, 0.0, 10.0),
             log_sigma,
             -0.5 * n * (LOG_2PI + 2.0 * log_sigma),
             -0.5 * sse / (sigma * sigma)]
    return _total(terms)


def _total(terms: list) -> tuple:
    """U = −Σ terms, and the magnitude Σ |terms| that sets its rounding
    (U itself can pass through 0 while its terms are large)."""
    u = terms[0]
    mag = torch.abs(terms[0])
    for t in terms[1:]:
        u = u + t
        mag = mag + torch.abs(torch.as_tensor(t))
    return -u, mag


POTENTIALS = {"eight_schools": eight_schools, "diamonds": diamonds}


def potential(config: dict, x: np.ndarray, dtype: str = "float64",
              block: int = 65536, magnitude: bool = False):
    """U at the rows of ``x`` (n, d), computed in ``dtype`` in blocks of
    rows, as float64; with ``magnitude`` also Σ |terms| of each."""
    dt = getattr(torch, dtype)
    fn = POTENTIALS[config["target"]]
    x = np.asarray(x)
    out = np.empty(x.shape[0], np.float64)
    mag = np.empty(x.shape[0], np.float64)
    for i in range(0, x.shape[0], block):
        xb = torch.as_tensor(x[i:i + block], dtype=torch.float64).to(dt)
        u, m = fn(xb, config)
        out[i:i + block] = u.to(torch.float64).numpy()
        mag[i:i + block] = m.to(torch.float64).numpy()
    return (out, mag) if magnitude else out
