"""The port's posterior utilities (adaptive_mcmc_tpu_torch.analysis
.posterior) against the JAX module on the same numpy inputs: pe_offset
and functional_convergence at rtol 1e-6; posterior_predictive for kidiq,
both eight-schools forms and diamonds, with the noise recovered by
replaying the generator and y_rep − σ·z held at rtol 1e-5 to the location
computed from JAX's ``target.constrain``.  Everything runs on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu.analysis import posterior as jpost  # noqa: E402
from adaptive_mcmc_tpu.models import data as jdata  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.analysis import posterior  # noqa: E402


def test_pe_offset_matches_jax():
    pe = np.random.default_rng(0).normal(40.0, 5.0, size=(25, 40)) \
        .astype(np.float32)
    got = posterior.pe_offset(torch.from_numpy(pe))
    np.testing.assert_allclose(got.numpy(), np.asarray(jpost.pe_offset(pe)),
                               rtol=1e-6)
    assert got.shape == ()


def test_functional_convergence_matches_jax():
    x = np.random.default_rng(1).normal(size=(300, 10)).astype(np.float32)
    got = posterior.functional_convergence(torch.from_numpy(x),
                                           lambda th: th.min())
    want = jpost.functional_convergence(jnp.asarray(x), jnp.min)
    assert got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _draws(name, n, rng):
    """Unconstrained draws whose locations sit away from zero (the rtol
    comparison needs no atol)."""
    if name == "kidiq":
        beta = np.stack([rng.normal(26, 1, n), rng.normal(6, 0.5, n),
                         rng.normal(0.6, 0.02, n)], 1)
        return np.concatenate([beta, rng.normal(2.9, 0.05, (n, 1))], 1)
    if name == "diamonds":
        return np.concatenate([rng.normal(7.7, 0.1, (n, 1)),
                               rng.normal(0, 0.01, (n, 24)),
                               rng.normal(-1.5, 0.1, (n, 1))], 1)
    mu = rng.normal(10.0, 0.5, (n, 1))
    log_tau = rng.uniform(-1.0, 0.5, (n, 1))
    if name == "eight_schools_noncentered":
        return np.concatenate([mu, log_tau, rng.uniform(-1, 1, (n, 8))], 1)
    return np.concatenate([mu, log_tau, rng.normal(10.0, 1.0, (n, 8))], 1)


def _location_and_sigma(jt, x):
    """float64 location and noise scale of y_rep from JAX's constrain."""
    sites = {k: np.asarray(v, np.float64)
             for k, v in jt.constrain(jnp.asarray(x)).items()}
    if jt.name == "kidiq":
        d = jdata.kidiq()
        X = np.stack([np.ones_like(d["mom_hs"]), d["mom_hs"], d["mom_iq"]],
                     1).astype(np.float64)
        return sites["beta"] @ X.T, sites["sigma"][:, None]
    if jt.name == "diamonds":
        X = np.asarray(jdata.diamonds()["X"], np.float64)
        Xc = X[:, 1:] - X[:, 1:].mean(0, keepdims=True)
        return (sites["Intercept"][:, None] + sites["b"] @ Xc.T,
                sites["sigma"][:, None])
    sigma = np.asarray(jdata.eight_schools()["sigma"], np.float64)
    theta = sites["theta"] if "theta" in sites else \
        sites["mu"][:, None] + sites["tau"][:, None] * sites["theta_base"]
    return theta, sigma[None, :]


@pytest.mark.parametrize("name,key", [
    ("kidiq", "kid_score_rep"),
    ("eight_schools_noncentered", "y_rep"),
    ("eight_schools_centered", "y_rep"),
    ("diamonds", "Y_rep"),
])
def test_posterior_predictive_location_matches_jax(name, key):
    n = 6
    x = _draws(name, n, np.random.default_rng(2)).astype(np.float32)
    target, jt = getattr(amt, name)(), getattr(jm, name)()
    out = posterior.posterior_predictive(
        target, torch.Generator().manual_seed(7), torch.from_numpy(x))
    assert list(out) == [key]
    y_rep = out[key].numpy().astype(np.float64)
    loc, sigma = _location_and_sigma(jt, x)
    assert y_rep.shape == loc.shape
    # the noise: one randn of y_rep's shape from the replayed generator
    z = torch.randn(y_rep.shape, generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(y_rep - sigma * z.numpy(), loc, rtol=1e-5)
    # the JAX module draws the same location under its own noise
    jy = np.asarray(jpost.posterior_predictive(
        jt, jax.random.PRNGKey(0), jnp.asarray(x))[key])
    assert jy.shape == y_rep.shape and np.isfinite(jy).all()


def test_posterior_predictive_refuses_an_unknown_target():
    with pytest.raises(ValueError, match="no predictive sampler"):
        posterior.posterior_predictive(amt.std_normal(2),
                                       torch.Generator().manual_seed(0),
                                       torch.zeros(3, 2))
