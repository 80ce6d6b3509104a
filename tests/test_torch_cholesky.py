"""Port parity: the rank-1 Cholesky update (kernel K1's plain version and
the adaptation step around it) against adaptive_mcmc_tpu's scan version and
its Pallas kernel in interpret mode, on the same numpy inputs.  Tolerance
rtol = atol = 1e-5, that of tests/test_pallas.py: float32 recursions that
associate differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu.ops import cholesky as jch  # noqa: E402
from adaptive_mcmc_tpu.ops.pallas.chol_update import (  # noqa: E402
    chol_update_pallas,
)
from adaptive_mcmc_tpu_torch.ops import cholesky as tch  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import chol_update as k1  # noqa: E402


def _rand_chols(C, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(C, d, d)) * 0.4
    cov = np.einsum("cij,ckj->cik", a, a) + np.eye(d)
    return np.linalg.cholesky(cov).astype(np.float32)


def _inputs(C, d, seed=0):
    rng = np.random.default_rng(seed + 1)
    L = _rand_chols(C, d, seed)
    v = rng.normal(size=(C, d)).astype(np.float32)
    coef = np.linspace(0.01, 0.9, C).astype(np.float32)
    return L, v, coef


SHAPES = [(4, 3), (130, 10), (300, 26), (128, 1), (37, 5)]


@pytest.mark.parametrize("C,d", SHAPES)
def test_plain_versions_match_jax_scan_and_pallas(C, d):
    L, v, coef = _inputs(C, d)
    scan = np.asarray(jax.vmap(jch.rank1_cholesky_update)(
        jnp.asarray(L), jnp.asarray(v), jnp.asarray(coef)))
    pallas = np.asarray(chol_update_pallas(
        jnp.asarray(L), jnp.asarray(v), jnp.asarray(coef), interpret=True))
    tL, tv, tc = map(torch.from_numpy, (L, v, coef))
    for got in (
        k1.chol_update_reference(tL, tv, tc),
        k1.chol_update(tL, tv, tc),                      # CPU dispatch
        tch.rank1_cholesky_update_batched(tL, tv, tc),
    ):
        got = got.numpy()
        np.testing.assert_allclose(got, scan, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
        # strictly lower triangular with a positive diagonal
        np.testing.assert_array_equal(got, np.tril(got))
        assert (np.diagonal(got, axis1=1, axis2=2) > 0).all()


@pytest.mark.parametrize("C,d", [(4, 3), (37, 5), (130, 10)])
def test_chains_last_entry_equals_chains_first(C, d):
    L, v, coef = _inputs(C, d, seed=4)
    tL, tv, tc = map(torch.from_numpy, (L, v, coef))
    first = k1.chol_update(tL, tv, tc)
    last = k1.chol_update_cl(tL.permute(1, 2, 0).contiguous(),
                             tv.t().contiguous(), tc)
    np.testing.assert_array_equal(last.permute(2, 0, 1).numpy(),
                                  first.numpy())


@pytest.mark.parametrize("d", [1, 4, 10])
def test_single_factor_matches_jax(d):
    L, v, coef = _inputs(3, d, seed=7)
    for c in range(3):
        want = np.asarray(jch.rank1_cholesky_update(
            jnp.asarray(L[c]), jnp.asarray(v[c]), float(coef[c])))
        got = tch.rank1_cholesky_update(
            torch.from_numpy(L[c]), torch.from_numpy(v[c]), float(coef[c]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_downdate_nan_in_both_and_guard_keeps_old_factor():
    """An indefinite downdate gives NaN in the JAX kernel and the port
    alike, and adaptive_scale_update then keeps the old factor per chain."""
    d, C = 4, 128
    L = np.broadcast_to(np.eye(d, dtype=np.float32), (C, d, d)).copy()
    v = np.zeros((C, d), np.float32)
    v[:, 0] = 10.0
    coef = np.full((C,), -1.0, np.float32)     # I - 100 e0 e0^T: indefinite
    want = np.asarray(chol_update_pallas(
        jnp.asarray(L), jnp.asarray(v), jnp.asarray(coef), interpret=True))
    got = k1.chol_update(*map(torch.from_numpy, (L, v, coef))).numpy()
    assert np.isnan(want).any() and np.isnan(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))

    # the guard: gamma > 1 on chains 0, 1 makes sqrt(1 - gamma) NaN there
    Lc = _rand_chols(8, d, seed=8)
    delta = np.random.default_rng(9).normal(size=(8, d)).astype(np.float32)
    gamma = np.full((8,), 0.3, np.float32)
    gamma[:2] = 1.5
    jout = np.asarray(jch.adaptive_scale_update(
        jnp.asarray(Lc), jnp.asarray(delta), jnp.asarray(gamma)))
    tout = tch.adaptive_scale_update(
        *map(torch.from_numpy, (Lc, delta, gamma))).numpy()
    np.testing.assert_array_equal(tout[:2], Lc[:2])
    assert not np.isnan(tout).any()
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    tcl = tch.adaptive_scale_update_cl(
        torch.from_numpy(Lc).permute(1, 2, 0).contiguous(),
        torch.from_numpy(delta).t().contiguous(), torch.from_numpy(gamma),
    ).permute(2, 0, 1).numpy()
    np.testing.assert_array_equal(tcl, tout)


@pytest.mark.parametrize("C,d", [(6, 4), (200, 26)])
def test_adaptive_scale_update_matches_jax(C, d):
    rng = np.random.default_rng(6)
    L = _rand_chols(C, d, seed=6)
    delta = rng.normal(size=(C, d)).astype(np.float32)
    gamma = np.linspace(0.01, 0.5, C).astype(np.float32)
    want = np.asarray(jch.adaptive_scale_update(
        jnp.asarray(L), jnp.asarray(delta), jnp.asarray(gamma)))
    got = tch.adaptive_scale_update(
        *map(torch.from_numpy, (L, delta, gamma))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the single-factor form with its scalar guard
    got1 = tch.adaptive_scale_update(
        torch.from_numpy(L[0]), torch.from_numpy(delta[0]), float(gamma[0]))
    np.testing.assert_allclose(got1.numpy(), want[0], rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_shapes_and_dtypes():
    L, v, coef = map(torch.from_numpy, _inputs(4, 3))
    with pytest.raises(ValueError):
        k1.chol_update_cl(L.permute(1, 2, 0), v, coef)          # v not (d, C)
    with pytest.raises(TypeError):
        k1.chol_update(L.double(), v.double(), coef.double())


@pytest.mark.parametrize("C,d", [(37, 5), (130, 10), (64, 26)])
def test_both_entries_take_strided_views_and_match_jax(C, d):
    """Chains-first and chains-last entries on non-contiguous views of L and
    v (a slice of a wider array; the transposed views of the other layout)
    against the JAX scan and the Pallas kernel in interpret mode."""
    L, v, coef = _inputs(C, d, seed=11)
    scan = np.asarray(jax.vmap(jch.rank1_cholesky_update)(
        jnp.asarray(L), jnp.asarray(v), jnp.asarray(coef)))
    pallas = np.asarray(chol_update_pallas(
        jnp.asarray(L), jnp.asarray(v), jnp.asarray(coef), interpret=True))
    wide_L = torch.zeros((C, d, 2 * d))
    wide_L[:, :, :d] = torch.from_numpy(L)
    wide_v = torch.zeros((C, 2 * d))
    wide_v[:, ::2] = torch.from_numpy(v)
    tL, tv, tc = wide_L[:, :, :d], wide_v[:, ::2], torch.from_numpy(coef)
    assert not tL.is_contiguous() and not tv.is_contiguous()
    first = k1.chol_update(tL, tv, tc)
    Lt, vt = tL.permute(1, 2, 0), tv.t()
    assert not Lt.is_contiguous() and not vt.is_contiguous()
    last = k1.chol_update_cl(Lt, vt, tc)
    assert first.shape == (C, d, d) and last.shape == (d, d, C)
    assert first.is_contiguous()
    np.testing.assert_array_equal(last.permute(2, 0, 1).numpy(),
                                  first.numpy())
    for want in (scan, pallas):
        np.testing.assert_allclose(first.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(first.numpy(), np.tril(first.numpy()))
    # the inputs are left as they were
    np.testing.assert_array_equal(tL.numpy(), L)
    np.testing.assert_array_equal(tv.numpy(), v)


def test_chains_first_entry_rejects_the_other_layout():
    L, v, coef = map(torch.from_numpy, _inputs(4, 3))
    with pytest.raises(ValueError):
        k1.chol_update(L.permute(1, 2, 0), v.t(), coef)
    with pytest.raises(ValueError):
        k1.chol_update(L, v.t(), coef)
