"""Diamonds (PosteriorDB ``diamonds-diamonds``, brms): x = [Intercept,
b(24), log sigma]; Intercept ~ StudentT(3, 8, 10), b ~ N(0, 1), sigma ~
half StudentT(3, 0, 10), Y ~ N(Intercept + Xc b, sigma) with Xc the
centred predictors, through the raw sufficient statistics (A = XcᵀXc,
c = XcᵀYc, yty = YcᵀYc, ȳ, N): the residual sum is
yty − 2 cᵀb + bᵀA b + N (Intercept − ȳ)², exact for this model.  The
statistics are the configuration's ``data`` file."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.potentials import (DATA, LOG_2PI, const, student_t,
                                            total)


def raw(config: dict) -> dict:
    """The configuration's data as float64 numpy arrays."""
    s = np.load(Path(config.get("data_dir", DATA)) / config["data"])
    return {k: np.asarray(s[k], np.float64)
            for k in ("A", "c", "yty", "ybar", "n")}


def potential(x, config: dict):
    data = const(config, x)
    A, c, s = data["A"], data["c"], data["raw"]
    yty, ybar, n = float(s["yty"]), float(s["ybar"]), float(s["n"])
    a, b, log_sigma = x[:, 0], x[:, 1:-1], x[:, -1]
    sigma = torch.exp(log_sigma)
    sse = (yty - 2.0 * (b @ c) + torch.sum((b @ A) * b, dim=1)
           + n * (a - ybar) ** 2)
    terms = [student_t(a, 3.0, 8.0, 10.0),
             torch.sum(-0.5 * (b * b + LOG_2PI), dim=1),
             math.log(2.0) + student_t(sigma, 3.0, 0.0, 10.0),
             log_sigma,
             -0.5 * n * (LOG_2PI + 2.0 * log_sigma),
             -0.5 * sse / (sigma * sigma)]
    return total(terms)
