"""Port parity: target potentials and site transforms of
adaptive_mcmc_tpu_torch against adaptive_mcmc_tpu, on the same numpy
inputs.  Tolerance rtol 1e-5: float32 evaluations of the same expression in
two frameworks, differing in summation order and transcendental rounding."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu_torch import models as tm  # noqa: E402


def _points(d, n=64, seed=0):
    """Seeded points plus extreme rows where the potential is inf or NaN."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    x[0, :] = 0.0
    x[1, :] = 40.0
    x[2, :] = -40.0
    x[3, 0] = 1e30
    x[4, 0] = np.inf
    x[5, 0] = np.nan
    if d > 1:
        x[6, 1] = 100.0    # tau = exp(100) overflows: potential inf / NaN
        x[7, 1] = -100.0   # tau underflows to 0
    return x


def _mvn_args(d=4, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)) * 0.5
    cov = a @ a.T + np.eye(d)
    return (rng.normal(size=d).astype(np.float32),
            np.linalg.cholesky(cov).astype(np.float32))


TARGETS = {
    "eight_schools_noncentered": (jm.eight_schools_noncentered,
                                  tm.eight_schools_noncentered, ()),
    "std_normal_5": (jm.std_normal, tm.std_normal, (5,)),
    "mvn_4": (jm.mvn, tm.mvn, _mvn_args()),
    "gaussian_mixture_1d": (jm.gaussian_mixture_1d, tm.gaussian_mixture_1d,
                            ()),
}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_potential_matches_jax(name):
    jbuild, tbuild, args = TARGETS[name]
    jt, tt = jbuild(*args), tbuild(*args)
    assert jt.dim == tt.dim and jt.name == tt.name
    x = _points(jt.dim)
    want = np.asarray(jax.vmap(jt.potential_fn)(jnp.asarray(x)))
    got = tt.potential_fn(torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0],) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not np.isfinite(want).all()   # the extreme rows are exercised


def test_eight_schools_data_matches_jax():
    from adaptive_mcmc_tpu.models import data as jdata
    from adaptive_mcmc_tpu_torch.models import data as tdata

    for k in ("y", "sigma"):
        np.testing.assert_array_equal(tdata.eight_schools()[k],
                                      jdata.eight_schools()[k])


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_constrain_unconstrain_round_trip(name):
    jbuild, tbuild, args = TARGETS[name]
    jt, tt = jbuild(*args), tbuild(*args)
    x = np.random.default_rng(3).normal(size=(5, 7, jt.dim)) \
        .astype(np.float32)
    jsites = jt.constrain(jnp.asarray(x))
    tsites = tt.constrain(torch.from_numpy(x))
    assert list(jsites) == list(tsites)
    for k in jsites:
        np.testing.assert_allclose(tsites[k].numpy(), np.asarray(jsites[k]),
                                   rtol=1e-6)
    back = tt.unconstrain({k: np.asarray(v) for k, v in jsites.items()})
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jt.unconstrain(jsites)), rtol=1e-6,
        atol=1e-7,
    )


def test_init_position_is_uniform_in_radius():
    t = tm.eight_schools_noncentered()
    g = torch.Generator().manual_seed(0)
    x = t.init_position(g, 4096)
    assert x.shape == (4096, 10) and x.dtype == torch.float32
    assert float(x.min()) >= -2.0 and float(x.max()) < 2.0
    assert abs(float(x.mean())) < 0.05


@pytest.mark.parametrize("name,args", [
    ("normal_logpdf", (0.5, 2.0)),
    ("half_cauchy_logpdf", (5.0,)),
    ("student_t_logpdf", (3.0, 8.0, 10.0)),
    ("folded_student_t_logpdf", (3.0, 0.0, 10.0)),
])
def test_logpdf_helpers_match_jax(name, args):
    x = np.abs(np.random.default_rng(4).normal(size=257) * 20.0) \
        .astype(np.float32)
    want = np.asarray(getattr(jm, name)(jnp.asarray(x), *args))
    got = getattr(tm, name)(torch.from_numpy(x), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
