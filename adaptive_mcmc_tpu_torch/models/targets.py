"""Concrete targets with batched potentials (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/models/targets.py``: the three
PosteriorDB posteriors (eight schools noncentered and centered, diamonds,
kidiq), plus the synthetic ``std_normal``, ``gaussian_mixture_1d`` and
``mvn`` targets of the statistical tests.  Each potential takes
``(C, dim)`` and returns ``(C,)``.  A target with a ``device_potential`` tag
is written in the operation order of its ``__device__`` twin in
``csrc/common.cuh`` (sums left to right, or by ``sum_strided``), so that the
fused kernels and their plain versions round alike on the card; its
``data["kernel_data"]`` is the flat float32 array that twin reads.
"""

from __future__ import annotations

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.models import data as _data
from adaptive_mcmc_tpu_torch.models.base import (
    _LOG_2PI,
    DeviceConstants,
    SiteSpec,
    Target,
    folded_student_t_logpdf,
    half_cauchy_logpdf,
    normal_logpdf,
    student_t_logpdf,
    sum_in_order,
    sum_strided,
)

_LOG_2PI_F32 = float(np.log(np.float32(2 * np.pi)))
# log 2 pi rounded to float32, as the JAX diamonds potential holds it
_LOG_2PI_T = float(np.float32(_LOG_2PI))
# the running sums of kidiq's residual sum (kKidiqLanes in csrc/common.cuh)
KIDIQ_LANES = 14


def eight_schools_noncentered(dataset: dict | None = None) -> Target:
    """Non-centered eight schools: mu ~ N(0,5), tau ~ HalfCauchy(5),
    theta = mu + tau * theta_base, theta_base ~ N(0,1), y ~ N(theta, sigma).

    Flat layout: [mu, log(tau), theta_base(8)] — dim 10.
    """
    d = dataset or _data.eight_schools()
    consts = _eight_schools_constants(d)
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
        device_potential="eight_schools_noncentered",
    )


def _eight_schools_constants(d: dict) -> DeviceConstants:
    y, sigma = np.asarray(d["y"], np.float32), np.asarray(d["sigma"],
                                                         np.float32)
    return DeviceConstants(y=y, sigma=sigma,
                           kernel_data=np.concatenate([y, sigma]))


def eight_schools_centered(dataset: dict | None = None) -> Target:
    """Centered eight schools (the lr-decay experiments): mu ~ N(0,5),
    tau ~ HalfCauchy(5), theta ~ N(mu, tau), y ~ N(theta, sigma).

    Flat layout: [mu, log(tau), theta(8)] — dim 10.
    """
    d = dataset or _data.eight_schools()
    consts = _eight_schools_constants(d)
    J = int(np.asarray(d["y"]).shape[0])

    def potential(x):
        c = consts.on(x.device)
        mu, log_tau, theta = x[:, 0], x[:, 1], x[:, 2:]
        tau = torch.exp(log_tau)
        lp = normal_logpdf(mu, 0.0, 5.0)
        lp = lp + (half_cauchy_logpdf(tau, 5.0) + log_tau)
        lp = lp + sum_in_order(normal_logpdf(theta, mu[:, None],
                                             tau[:, None]))
        lp = lp + sum_in_order(normal_logpdf(c["y"], theta, c["sigma"]))
        return -lp

    return Target(
        name="eight_schools_centered",
        dim=2 + J,
        potential_fn=potential,
        sites=(
            SiteSpec("mu", 1, ()),
            SiteSpec("tau", 1, (), "exp"),
            SiteSpec("theta", J, (J,)),
        ),
        data=consts,
        device_potential="eight_schools_centered",
    )


def diamonds(dataset: dict | None = None, *,
             suff_stats: bool = True) -> Target:
    """Diamonds GLM (brms-style): predictors centered in the model,
    b ~ N(0,1)^Kc, Intercept ~ StudentT(3,8,10),
    sigma ~ Folded(StudentT(3,0,10)), Y ~ N(Intercept + Xc b, sigma).

    Flat layout: [Intercept, b(Kc), log(sigma)] — dim Kc + 2 (26 for the
    real design).

    ``suff_stats`` (default): the likelihood through the data's sufficient
    statistics, in the cancellation-free form

        SSE = ‖Y − a·1 − Xc b‖² = SSE_min + N (a − Ȳ)² + ‖Lᵀ(b − b̂)‖²

    with b̂ the OLS fit, L = chol(XcᵀXc) and SSE_min the OLS residual sum,
    built in float64 on the host and run in float32.  Do NOT expand it to
    ycᵀyc − 2bᵀXcᵀyc + bᵀXcᵀXc b: at cond(XcᵀXc) ≈ 3.4e5 its three
    ~ycᵀyc-sized float32 terms cancel almost totally, and the rounding that
    survives biased the collinear coefficients' posterior means by about
    0.08 gold sd in the JAX package (``adaptive_mcmc_tpu/models/
    targets.py``).  Only this form has a device potential (tag
    ``diamonds_ss``); ``suff_stats=False`` is the dense O(N·Kc) likelihood
    and runs on the plain drivers only.
    """
    d = dataset or _data.diamonds()
    X64 = np.asarray(d["X"], np.float64)[:, 1:]
    X64 = X64 - X64.mean(axis=0, keepdims=True)
    Kc = X64.shape[1]
    sites = (
        SiteSpec("Intercept", 1, ()),
        SiteSpec("b", Kc, (Kc,)),
        SiteSpec("sigma", 1, (), "exp"),
    )

    def prior(a, b, log_sigma, sigma):
        lp = student_t_logpdf(a, 3.0, 8.0, 10.0)
        lp = lp + sum_in_order(normal_logpdf(b))
        return lp + (folded_student_t_logpdf(sigma, 3.0, 0.0, 10.0)
                     + log_sigma)

    if not suff_stats:
        X = np.asarray(d["X"], np.float32)
        Xc = X[:, 1:] - X[:, 1:].mean(axis=0, keepdims=True)
        consts = DeviceConstants(Xc=Xc, Y=d["Y"])

        def potential(x):
            c = consts.on(x.device)
            a, b, log_sigma = x[:, 0], x[:, 1:1 + Kc], x[:, 1 + Kc]
            sigma = torch.exp(log_sigma)
            lp = prior(a, b, log_sigma, sigma)
            mu = a[:, None] + b @ c["Xc"].t()               # (C, N)
            return -(lp + torch.sum(normal_logpdf(c["Y"], mu,
                                                  sigma[:, None]), dim=-1))

        return Target(name="diamonds", dim=Kc + 2, potential_fn=potential,
                      sites=sites, data=consts)

    Y64 = np.asarray(d["Y"], np.float64)
    N = Y64.shape[0]
    y_bar = Y64.mean()
    yc64 = Y64 - y_bar
    gram64 = X64.T @ X64
    xty64 = X64.T @ yc64
    b_hat64 = np.linalg.solve(gram64, xty64)
    lt = np.linalg.cholesky(gram64).T.astype(np.float32)  # (Kc, Kc) upper
    b_hat = b_hat64.astype(np.float32)
    sse_min = np.float32(yc64 @ yc64 - b_hat64 @ xty64)
    n_f, y_bar32 = np.float32(N), np.float32(y_bar)
    consts = DeviceConstants(
        lt=lt, b_hat=b_hat,
        kernel_data=np.concatenate([lt.ravel(), b_hat,
                                    [sse_min, n_f, y_bar32]]),
    )
    sse_min, n_f, y_bar32 = float(sse_min), float(n_f), float(y_bar32)

    def potential(x):
        c = consts.on(x.device)
        a, b, log_sigma = x[:, 0], x[:, 1:1 + Kc], x[:, 1 + Kc]
        sigma = torch.exp(log_sigma)
        lp = prior(a, b, log_sigma, sigma)
        # u = Lᵀ(b − b̂), summed over columns left to right: the zero lower
        # triangle of Lᵀ adds exact zeros, which the device twin skips
        r = b - c["b_hat"]
        lt_ = c["lt"]
        u = lt_[:, 0] * r[:, :1]
        for j in range(1, Kc):
            u = u + lt_[:, j] * r[:, j:j + 1]
        da = a - y_bar32
        sse = sse_min + n_f * da * da + sum_in_order(u * u)
        lp = lp + (-0.5 * n_f * (_LOG_2PI_T + 2.0 * log_sigma)
                   - 0.5 * sse / (sigma * sigma))
        return -lp

    return Target(name="diamonds", dim=Kc + 2, potential_fn=potential,
                  sites=sites, data=consts, device_potential="diamonds_ss")


def kidiq(dataset: dict | None = None) -> Target:
    """kidiq regression: beta ~ ImproperUniform(R^3), sigma ~
    HalfCauchy(2.5), kid_score ~ N([1, mom_hs, mom_iq] @ beta, sigma).

    Flat layout: [beta(3), log(sigma)] — dim 4.  The N-term residual sum
    runs as ``KIDIQ_LANES`` running sums (``sum_strided``), the device
    twin's order.
    """
    d = dataset or _data.kidiq()
    ks, hs, iq = (np.asarray(d[k], np.float32)
                  for k in ("kid_score", "mom_hs", "mom_iq"))
    consts = DeviceConstants(kid_score=ks, mom_hs=hs, mom_iq=iq,
                             kernel_data=np.concatenate([ks, hs, iq]))

    def potential(x):
        c = consts.on(x.device)
        beta, log_sigma = x[:, :3], x[:, 3]
        sigma = torch.exp(log_sigma)
        lp = half_cauchy_logpdf(sigma, 2.5) + log_sigma   # beta: flat
        mu = (beta[:, 0:1] + beta[:, 1:2] * c["mom_hs"]) \
            + beta[:, 2:3] * c["mom_iq"]
        return -(lp + sum_strided(normal_logpdf(c["kid_score"], mu,
                                                sigma[:, None]),
                                  KIDIQ_LANES))

    return Target(
        name="kidiq",
        dim=4,
        potential_fn=potential,
        sites=(SiteSpec("beta", 3, (3,)), SiteSpec("sigma", 1, (), "exp")),
        data=consts,
        device_potential="kidiq",
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
