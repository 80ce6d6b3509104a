"""Concrete targets with batched potentials (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/models/targets.py``: the eight-schools
noncentered posterior of the main path, plus the synthetic ``std_normal``,
``gaussian_mixture_1d`` and ``mvn`` targets of the statistical tests.  Each
potential takes ``(C, dim)`` and returns ``(C,)``, written in the same
operation order as the JAX package's per-chain potential so both round
alike in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.models import data as _data
from adaptive_mcmc_tpu_torch.models.base import (
    DeviceConstants,
    SiteSpec,
    Target,
    half_cauchy_logpdf,
    normal_logpdf,
    sum_in_order,
)

_LOG_2PI_F32 = float(np.log(np.float32(2 * np.pi)))


def eight_schools_noncentered(dataset: dict | None = None) -> Target:
    """Non-centered eight schools: mu ~ N(0,5), tau ~ HalfCauchy(5),
    theta = mu + tau * theta_base, theta_base ~ N(0,1), y ~ N(theta, sigma).

    Flat layout: [mu, log(tau), theta_base(8)] — dim 10.
    """
    d = dataset or _data.eight_schools()
    consts = DeviceConstants(y=d["y"], sigma=d["sigma"])
    J = int(np.asarray(d["y"]).shape[0])

    def potential(x):
        c = consts.on(x.device)
        mu, log_tau, tb = x[:, 0], x[:, 1], x[:, 2:]
        tau = torch.exp(log_tau)
        lp = normal_logpdf(mu, 0.0, 5.0)
        lp = lp + (half_cauchy_logpdf(tau, 5.0) + log_tau)
        lp = lp + sum_in_order(normal_logpdf(tb))
        theta = mu[:, None] + tau[:, None] * tb
        lp = lp + sum_in_order(normal_logpdf(c["y"], theta, c["sigma"]))
        return -lp

    return Target(
        name="eight_schools_noncentered",
        dim=2 + J,
        potential_fn=potential,
        sites=(
            SiteSpec("mu", 1, ()),
            SiteSpec("tau", 1, (), "exp"),
            SiteSpec("theta_base", J, (J,)),
        ),
        data=consts,
    )


def std_normal(dim: int = 1) -> Target:
    def potential(x):
        return 0.5 * torch.sum(x * x, dim=-1) + 0.5 * dim * _LOG_2PI_F32

    return Target(
        name=f"std_normal_{dim}d", dim=dim, potential_fn=potential,
        sites=(SiteSpec("x", dim, (dim,)),),
    )


def gaussian_mixture_1d(locs=(-1.0, 1.0), scale=0.1,
                        weights=(0.5, 0.5)) -> Target:
    """Two-component 1-D Gaussian mixture (the mode-switching target of
    the statistical tests)."""
    consts = DeviceConstants(locs=np.asarray(locs, np.float32),
                             log_w=np.log(np.asarray(weights, np.float32)))

    def potential(x):
        c = consts.on(x.device)
        comp = normal_logpdf(x[:, :1], c["locs"], scale) + c["log_w"]
        return -torch.logsumexp(comp, dim=-1)

    return Target(
        name="gaussian_mixture_1d", dim=1, potential_fn=potential,
        sites=(SiteSpec("x", 1, ()),),
    )


def mvn(loc, chol_cov) -> Target:
    """General multivariate normal given mean and Cholesky of covariance."""
    loc_np = np.asarray(loc, np.float32)
    L_np = np.asarray(chol_cov, np.float32)
    dim = loc_np.shape[0]
    consts = DeviceConstants(loc=loc_np, L=L_np)
    half_logdet = float(np.sum(np.log(np.diagonal(L_np))))

    def potential(x):
        c = consts.on(x.device)
        r = (x - c["loc"]).transpose(0, 1)                    # (dim, C)
        z = torch.linalg.solve_triangular(c["L"], r, upper=False)
        return (0.5 * torch.sum(z * z, dim=0) + half_logdet
                + 0.5 * dim * _LOG_2PI_F32)

    return Target(
        name=f"mvn_{dim}d", dim=dim, potential_fn=potential,
        sites=(SiteSpec("x", dim, (dim,)),),
    )
