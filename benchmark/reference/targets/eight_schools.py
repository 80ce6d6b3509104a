"""Eight schools, non-centered (PosteriorDB ``eight_schools_noncentered``):
x = [mu, log tau, theta_base(8)]; mu ~ N(0, 5), tau ~ HalfCauchy(5),
theta_base ~ N(0, 1), y_j ~ N(mu + tau theta_base_j, sigma_j), plus the
Jacobian log tau.  The data are the configuration's ``y`` and ``sigma``."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.potentials import LOG_2PI, const, normal, total


def raw(config: dict) -> dict:
    """The configuration's data as float64 numpy arrays."""
    return {k: np.asarray(config[k], np.float64) for k in ("y", "sigma")}


def potential(x, config: dict):
    data = const(config, x)
    y, sigma = data["y"], data["sigma"]
    mu, log_tau, tb = x[:, 0], x[:, 1], x[:, 2:]
    tau = torch.exp(log_tau)
    theta = mu[:, None] + tau[:, None] * tb
    z = (y - theta) / sigma
    terms = [normal(mu, 0.0, 5.0),
             math.log(2.0 / (math.pi * 5.0)) - torch.log1p((tau / 5.0) ** 2),
             log_tau,
             torch.sum(-0.5 * (tb * tb + LOG_2PI), dim=1),
             torch.sum(-0.5 * (z * z + LOG_2PI) - torch.log(sigma), dim=1)]
    return total(terms)
