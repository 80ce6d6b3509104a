"""Port parity: target potentials, their autograd gradients, site
transforms and data of adaptive_mcmc_tpu_torch against adaptive_mcmc_tpu,
on the same numpy inputs.  Potentials: rtol 1e-5, atol 0 (float32
evaluations of the same expression in two frameworks, differing in
summation order and transcendental rounding).  Gradients: compared per row
against the row's largest entry (see ``GRAD_RTOL``).  Data: bit for bit."""

import functools
import math
import re
from pathlib import Path

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
    "eight_schools_centered": (jm.eight_schools_centered,
                               tm.eight_schools_centered, ()),
    "kidiq": (jm.kidiq, tm.kidiq, ()),
    "diamonds": (jm.diamonds, tm.diamonds, ()),
    "diamonds_dense": (functools.partial(jm.diamonds, suff_stats=False),
                       functools.partial(tm.diamonds, suff_stats=False), ()),
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
    if name == "eight_schools_centered":
        # tau divides here.  XLA on the CPU flushes float32 subnormals to
        # zero and PyTorch does not, and exp(-100) is subnormal: take a
        # log tau whose exp underflows to 0 in both
        x[7, 1] = -110.0
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


# ---- the PosteriorDB posteriors --------------------------------------------

POSTERIORDB = ("eight_schools_centered", "kidiq", "diamonds",
               "diamonds_dense")
# Gradients per row against the row's largest entry.  The diamonds
# gradient near the posterior is a nearly cancelling difference of prior
# and likelihood terms, summed in another order by XLA's dot than by the
# port's column loop; the accuracy that matters there is the gold-mean
# guard of test_diamonds_suff_stats_matches_dense.
GRAD_RTOL = {"diamonds": 1e-3, "diamonds_dense": 1e-3}


def _gold():
    return np.load(tm.data.DATA_DIR / "diamonds.npy")


def _kidiq_ols():
    """float64 OLS fit of the kidiq data: (b̂, standard errors, residual
    sd)."""
    d = tm.data.kidiq()
    X = np.stack([np.ones(len(d["kid_score"])), d["mom_hs"], d["mom_iq"]],
                 axis=1).astype(np.float64)
    y = d["kid_score"].astype(np.float64)
    xtx = X.T @ X
    b_hat = np.linalg.solve(xtx, X.T @ y)
    r = y - X @ b_hat
    s2 = (r @ r) / (len(y) - 3)
    return b_hat, np.sqrt(np.diag(np.linalg.inv(xtx)) * s2), np.sqrt(s2)


def _posterior_points(name, n=64, seed=5):
    """Seeded points where each posterior puts its mass."""
    rng = np.random.default_rng(seed)
    if name.startswith("diamonds"):
        return _gold()[rng.choice(10000, n, replace=False)].astype(np.float32)
    if name == "kidiq":
        b_hat, se, s = _kidiq_ols()
        x = np.empty((n, 4))
        x[:, :3] = b_hat + rng.normal(size=(n, 3)) * 2.0 * se
        x[:, 3] = np.log(s) + rng.normal(size=n) * 0.05
        return x.astype(np.float32)
    x = rng.normal(size=(n, 10)) * 2.0
    x[:, 0] += 4.4
    x[:, 1] = rng.normal(size=n) * 0.7 + 1.0
    x[:, 2:] += x[:, :1]
    return x.astype(np.float32)


@pytest.mark.parametrize("name", POSTERIORDB)
def test_potential_matches_jax_near_the_posterior(name):
    """rtol 1e-5, atol 0, where the samplers evaluate the potential."""
    jbuild, tbuild, args = TARGETS[name]
    jt, tt = jbuild(*args), tbuild(*args)
    x = _posterior_points(name)
    want = np.asarray(jax.vmap(jt.potential_fn)(jnp.asarray(x)))
    got = tt.potential_fn(torch.from_numpy(x)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _torch_grad(t, x):
    xt = torch.from_numpy(x).requires_grad_()
    t.potential_fn(xt).sum().backward()
    return xt.grad.numpy()


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_gradient_matches_jax(name):
    """Autograd through the batched potential against jax.grad of the JAX
    potential, at the finite rows of the seeded points (and, for the
    PosteriorDB targets, near the posterior)."""
    jbuild, tbuild, args = TARGETS[name]
    jt, tt = jbuild(*args), tbuild(*args)
    x = _points(jt.dim)[8:]
    if name in POSTERIORDB:
        x = np.concatenate([x, _posterior_points(name)])
    want = np.asarray(jax.vmap(jax.grad(jt.potential_fn))(jnp.asarray(x)))
    got = _torch_grad(tt, x)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    scale = np.abs(want).max(axis=1, keepdims=True)
    rel = np.abs(got - want) / scale
    assert rel.max() <= GRAD_RTOL.get(name, 1e-5), rel.max()


@pytest.mark.parametrize("dataset,keys", [
    ("kidiq", ("kid_score", "mom_hs", "mom_iq")),
    ("diamonds", ("X", "Y")),
])
def test_posteriordb_data_matches_jax(dataset, keys):
    """The seeded generators (and the vendored diamonds statistics, read in
    place) give the JAX package's arrays bit for bit."""
    from adaptive_mcmc_tpu.models import data as jdata

    want, got = getattr(jdata, dataset)(), getattr(tm.data, dataset)()
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_diamonds_suff_stats_matches_dense():
    """tests/test_models.py:71-175 on the port.  Both float32 forms against
    a float64 dense truth (pairwise differences, so constants cancel):
    tight near the gold draws, loose at wide excursions.  Then the guard
    against the textbook expansion's cancellation: the float32 autograd
    gradient error at the gold mean, mapped through the gold covariance,
    must predict a negligible posterior-mean shift.  Last, the two forms'
    gradients agree."""
    t_ss = tm.diamonds(suff_stats=True)
    t_dn = tm.diamonds(suff_stats=False)
    d = tm.data.diamonds()
    X = np.asarray(d["X"], np.float64)
    Y = np.asarray(d["Y"], np.float64)
    Kc = X.shape[1] - 1
    Xc = X[:, 1:] - X[:, 1:].mean(0, keepdims=True)
    N = len(Y)

    def pot64(x):
        x = np.asarray(x, np.float64)
        a, b, ls = x[0], x[1:1 + Kc], x[1 + Kc]
        sig = np.exp(ls)
        z = (a - 8.0) / 10.0
        lp = -2.0 * np.log1p(z * z / 3.0)
        lp += -0.5 * np.sum(b * b)
        zs = sig / 10.0
        lp += -2.0 * np.log1p(zs * zs / 3.0) + ls
        r = Y - (a + Xc @ b)
        lp += -N * ls - 0.5 * np.sum(r * r) / (sig * sig)
        return -lp

    def pot32(t, x):
        return t.potential_fn(torch.from_numpy(x)).numpy().astype(np.float64)

    rng = np.random.default_rng(7)
    base = np.zeros(t_ss.dim, np.float32)
    base[0], base[-1] = 8.0, -1.5
    pts = base + np.concatenate(
        [rng.standard_normal((64, t_ss.dim)) * 0.1,
         rng.standard_normal((64, t_ss.dim)) * 2.0]).astype(np.float32)
    pe_64 = np.array([pot64(p) for p in pts])
    for t, tag in ((t_ss, "suff"), (t_dn, "dense")):
        pe = pot32(t, pts)
        err = np.abs((pe[:64] - pe[32:96]) - (pe_64[:64] - pe_64[32:96]))
        rel = err / np.maximum(np.abs(pe_64[:64] - pe_64[32:96]), 1.0)
        assert rel[:32].max() < 1e-2, (tag, rel[:32].max())
        assert rel[32:].max() < 2e-2, (tag, rel[32:].max())

    gold = _gold().astype(np.float64)
    gm, gsd = gold.mean(0), gold.std(0)
    pp = (gm + np.random.default_rng(3).standard_normal((64, t_ss.dim))
          * gsd).astype(np.float32)
    pp64 = np.array([pot64(p) for p in pp])
    for t, tag in ((t_ss, "suff"), (t_dn, "dense")):
        pe = pot32(t, pp)
        dd = (pe[:32] - pe[32:]) - (pp64[:32] - pp64[32:])
        rel = np.abs(dd) / np.maximum(np.abs(pp64[:32] - pp64[32:]), 1.0)
        assert rel.max() < 2e-4, (tag, rel.max())

    cov = np.cov(gold.T)
    h = 1e-5
    eye = np.eye(t_ss.dim)
    g64 = np.array([(pot64(gm + h * eye[i]) - pot64(gm - h * eye[i]))
                    / (2 * h) for i in range(t_ss.dim)])
    for t, tag in ((t_ss, "suff"), (t_dn, "dense")):
        g32 = _torch_grad(t, gm[None].astype(np.float32))[0]
        shift = np.abs(cov @ (g32 - g64)) / gsd
        assert shift.max() < 5e-3, (tag, shift.max())

    np.testing.assert_allclose(_torch_grad(t_ss, pts[:1]),
                               _torch_grad(t_dn, pts[:1]),
                               rtol=5e-4, atol=5e-3)


def test_kernel_data_layouts():
    """The flat ``kernel_data`` each tagged target hands the fused kernels,
    in the layout the policies of csrc/common.cuh read."""
    es = tm.eight_schools_centered()
    e = tm.data.eight_schools()
    np.testing.assert_array_equal(es.data.on("cpu")["kernel_data"].numpy(),
                                  np.concatenate([e["y"], e["sigma"]]))
    kd = tm.data.kidiq()
    np.testing.assert_array_equal(
        tm.kidiq().data.on("cpu")["kernel_data"].numpy(),
        np.concatenate([kd["kid_score"], kd["mom_hs"], kd["mom_iq"]]))
    dm = tm.diamonds()
    c = {k: v.numpy() for k, v in dm.data.on("cpu").items()}
    Kc = dm.dim - 2
    flat = c["kernel_data"]
    assert flat.shape == (Kc * Kc + Kc + 3,)
    np.testing.assert_array_equal(flat[:Kc * Kc].reshape(Kc, Kc), c["lt"])
    assert np.array_equal(np.triu(c["lt"]), c["lt"])
    np.testing.assert_array_equal(flat[Kc * Kc:Kc * Kc + Kc], c["b_hat"])
    assert flat[-2] == 5000.0
    assert flat[-1] == np.float32(tm.data.diamonds()["Y"].astype(np.float64)
                                  .mean())
    for t in (tm.diamonds(suff_stats=False), tm.std_normal(2)):
        assert t.device_potential is None


def test_device_constants_are_pythons_doubles():
    """Every ``constexpr double`` of csrc/common.cuh equals the Python
    expression in its comment, which the plain versions fold, and kidiq's
    lane count is the plain version's."""
    src = (Path(tm.__file__).resolve().parents[1] / "csrc" / "common.cuh") \
        .read_text()
    found = re.findall(
        r"constexpr double (\w+) = ([-\d.e]+);\s*// (math\.\w+\([\d.]+\))",
        src)
    assert len(found) >= 6
    for name, value, expr in found:
        assert float(value) == eval(expr, {"math": math}), name
    lanes = re.search(r"constexpr int kKidiqLanes = (\d+);", src)
    assert int(lanes.group(1)) == tm.targets.KIDIQ_LANES


def test_logaddexp_is_atens_formula():
    """The device potentials write the folded Student-t's logaddexp as ATen
    does: max(a, b) + log1p(exp(-|a - b|)), and a for equal infinities."""
    rng = np.random.default_rng(9)
    a = (rng.normal(size=4099) * 30.0).astype(np.float32)
    b = (rng.normal(size=4099) * 30.0).astype(np.float32)
    b[:100] = a[:100]
    a[100:103] = b[100:103] = [np.inf, -np.inf, np.inf]
    b[102] = -np.inf
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    mine = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
    mine = torch.where(torch.isinf(a) & (a == b), a, mine)
    assert torch.equal(mine, torch.logaddexp(a, b))


def test_sum_strided_order():
    """sum_strided adds entry n into running sum n mod lanes, each left to
    right, then the running sums left to right: the kidiq kernel's order,
    bit for bit."""
    rng = np.random.default_rng(2)
    for n, lanes in ((434, 14), (37, 5), (3, 8)):
        a = (rng.normal(size=(6, n)) * 100.0).astype(np.float32)
        acc = np.zeros((6, lanes), np.float32)
        for i in range(n):
            acc[:, i % lanes] = acc[:, i % lanes] + a[:, i]
        want = acc[:, 0]
        for j in range(1, lanes):
            want = want + acc[:, j]
        got = tm.sum_strided(torch.from_numpy(a), lanes).numpy()
        np.testing.assert_array_equal(got, want)
