"""Analytic / quadrature ground truths for gold-standard validation
(PyTorch port: the port's own copy of
``adaptive_mcmc_tpu/experiments/quadrature.py``, numpy on the port's
``models.data``).

The self-generated NUTS gold standard (evaluate.make_reference_draws) is
circular — a kernel bug would be invisible (it grades itself).  Two of the
three PosteriorDB targets admit (semi-)analytic posterior moments in the
comparison space, which breaks the circle:

* eight-schools (non-centered, run_eight_schools_wasserstein.py:25-34):
  integrating theta_base out gives y_j ~ N(mu, sigma_j^2 + tau^2), so the
  (mu, log_tau) marginal is an explicit 2-D density — moments by dense-grid
  quadrature.
* kidiq (run_kidiq_kidscore_wasserstein.py:29-41): beta has an improper
  flat prior, so beta | sigma, y is Gaussian at the OLS solution and
  p(sigma | y) ∝ HalfCauchy(sigma; 2.5) · sigma^{-(n-k)} exp(-RSS/(2 s^2))
  — moments of log(sigma) by 1-D quadrature, E[beta] = OLS beta exactly.

diamonds has StudentT priors (no conjugate marginalization); its gold is
validated only by cross-kernel agreement.
"""

from __future__ import annotations

import numpy as np

from adaptive_mcmc_tpu_torch.models import data as _data


def eight_schools_truth() -> dict:
    """Quadrature moments of the eight-schools (mu, log_tau) marginal."""
    d = _data.eight_schools()
    y = np.asarray(d["y"], np.float64)
    sigma = np.asarray(d["sigma"], np.float64)
    mus = np.linspace(-25.0, 35.0, 1200)
    lts = np.linspace(-14.0, 5.0, 1900)
    MU, LT = np.meshgrid(mus, lts, indexing="ij")
    TAU = np.exp(LT)
    lp = -0.5 * (MU / 5.0) ** 2
    # HalfCauchy(5) density of tau, plus d tau / d log_tau Jacobian
    lp += np.log(2.0 / np.pi) - np.log(5.0 * (1.0 + (TAU / 5.0) ** 2)) + LT
    var = sigma[None, None, :] ** 2 + TAU[..., None] ** 2
    lp += np.sum(
        -0.5 * np.log(2.0 * np.pi * var)
        - 0.5 * (y[None, None, :] - MU[..., None]) ** 2 / var,
        axis=-1,
    )
    lp -= lp.max()
    w = np.exp(lp)
    w /= w.sum()
    e_lt = float((w * LT).sum())
    e_mu = float((w * MU).sum())
    sd_lt = float(np.sqrt((w * LT**2).sum() - e_lt**2))
    sd_mu = float(np.sqrt((w * MU**2).sum() - e_mu**2))
    return {
        "mean_log_tau": e_lt,
        "sd_log_tau": sd_lt,
        "mean_mu": e_mu,
        "sd_mu": sd_mu,
    }


def kidiq_truth() -> dict:
    """Semi-analytic kidiq moments: OLS beta, quadrature log_sigma."""
    d = _data.kidiq()
    ks = np.asarray(d["kid_score"], np.float64)
    X = np.stack(
        [np.ones_like(ks), np.asarray(d["mom_hs"], np.float64),
         np.asarray(d["mom_iq"], np.float64)],
        axis=1,
    )
    n, k = X.shape
    beta_hat, *_ = np.linalg.lstsq(X, ks, rcond=None)
    rss = float(np.sum((ks - X @ beta_hat) ** 2))
    ls = np.linspace(np.log(5.0), np.log(80.0), 40000)
    s = np.exp(ls)
    lp = (
        -np.log(1.0 + (s / 2.5) ** 2)   # HalfCauchy(2.5) shape
        + ls                            # Jacobian d sigma / d log_sigma
        - (n - k) * ls                  # |X^T X|^{-1/2} beta-marginalized
        - 0.5 * rss / s**2
    )
    lp -= lp.max()
    w = np.exp(lp)
    w /= w.sum()
    e_ls = float((w * ls).sum())
    sd_ls = float(np.sqrt((w * ls**2).sum() - e_ls**2))
    # E[beta | y] = OLS beta for every sigma, hence unconditionally.
    # Var[beta | y] = E[sigma^2] (X^T X)^{-1}.
    e_s2 = float((w * s**2).sum())
    cov_beta = e_s2 * np.linalg.inv(X.T @ X)
    return {
        "mean_beta": beta_hat,
        "sd_beta": np.sqrt(np.diag(cov_beta)),
        "mean_log_sigma": e_ls,
        "sd_log_sigma": sd_ls,
    }
