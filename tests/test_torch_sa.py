"""Port parity for the SA kernel: the leave-one-out factors through K1's
plain version against JAX's vmapped triple rank-1 update, the Gumbel-max
deletion draw against ``jax.random.categorical``, one step and a chained
replay against JAX on replayed draws, the SA state crossing between the
packages, the driver's diagnostics string and a moments check.

Tolerances: rtol 1e-4, atol 1e-5 throughout.  K1's plain version and JAX's
scan (``ops/cholesky.rank1_cholesky_update``) are two associations of the
GGMS74-C1 recursion, and the step adds a batched triangular solve and a
softmax in two float32 libraries.  NaN masks, deleted indices and reported
ensemble members must be equal; the chained replay is compared normwise.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu.kernels.base import split_keys  # noqa: E402
from adaptive_mcmc_tpu.kernels.sa import SAConfig as JSAConfig  # noqa: E402
from adaptive_mcmc_tpu.kernels.sa import sa as jsa  # noqa: E402
from adaptive_mcmc_tpu.ops.cholesky import (  # noqa: E402
    rank1_cholesky_update as j_rank1,
)
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.infer.mcmc import checked_step  # noqa: E402
from adaptive_mcmc_tpu_torch.kernels.sa import replace_stats  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ensembles(C, N, d, seed):
    """Random ensembles with their exact (loc, chol(cov)), and proposals."""
    rng = np.random.default_rng(seed)
    zs = rng.normal(size=(C, N, d)) * rng.uniform(0.5, 2.0, size=(C, 1, d))
    loc = zs.mean(1)
    cen = zs - loc[:, None]
    cov = np.einsum("cni,cnj->cij", cen, cen) / N + 1e-6 * np.eye(d)
    scale = np.linalg.cholesky(cov)
    w = loc + rng.normal(size=(C, d))
    return tuple(a.astype(np.float32) for a in (zs, loc, scale, w))


@jax.jit
def _jax_replace_stats(zs, loc, scale, w):
    """sa.py's _replace_stats, vmapped over candidates and chains."""
    N = zs.shape[1]
    inv_n = 1.0 / N

    def one(loc, scale, z_i, w):
        delta = (w - z_i) * inv_n
        s = j_rank1(scale, w - loc, inv_n)
        s = j_rank1(s, z_i - loc, -inv_n)
        s = j_rank1(s, delta, -1.0)
        return loc + delta, s

    per_chain = jax.vmap(one, in_axes=(None, None, 0, None))
    return jax.vmap(per_chain)(loc, scale, zs, w)


@pytest.mark.parametrize("d", [3, 10])
def test_replace_stats_through_k1_matches_jax_vmapped_triple(d):
    C, N = 4, max(24, 2 * d)
    zs, loc, scale, w = _ensembles(C, N, d, seed=d)
    # chain 0: a factor far too small for its ensemble, so the downdate by
    # (z_i - loc) / N is clearly indefinite for every candidate
    scale[0] = 0.01 * np.eye(d, dtype=np.float32)
    want_locs, want_scales = map(np.asarray,
                                 _jax_replace_stats(zs, loc, scale, w))
    locs, scales = replace_stats(*map(torch.from_numpy, (loc, scale, zs, w)),
                                 dense_mass=True)
    assert scales.shape == (C, N, d, d)
    np.testing.assert_allclose(locs.numpy(), want_locs, rtol=RTOL, atol=ATOL)
    nan = np.isnan(want_scales)
    assert nan[0].any() and not nan[1:].any()
    np.testing.assert_array_equal(np.isnan(scales.numpy()), nan)
    np.testing.assert_allclose(scales.numpy(), want_scales, rtol=RTOL,
                               atol=ATOL)
    # the healthy chains' factors are the exact leave-one-out factors
    got = scales[1:].double()
    cov_i = (got @ got.transpose(-1, -2)).numpy()
    zs_i = np.repeat(zs[1:, None].astype(np.float64), N, axis=1)
    zs_i[:, np.arange(N), np.arange(N)] = w[1:, None]
    cen = zs_i - zs_i.mean(2, keepdims=True)
    want_cov = np.einsum("cimk,ciml->cikl", cen, cen) / N
    np.testing.assert_allclose(cov_i, want_cov + 1e-6 * np.eye(d),
                               rtol=1e-3, atol=1e-4)


def test_argmax_takes_first_nan_or_first_maximum_as_jax():
    inf, nan = np.inf, np.nan
    rows = np.array([[1.0, nan, 3.0, nan], [1.0, 3.0, 3.0, 2.0],
                     [1.0, inf, 2.0, inf], [-inf, -inf, 0.0, 1.0],
                     [2.0, inf, nan, 1.0], [-inf, -inf, -inf, -inf]],
                    np.float32)
    got = torch.argmax(torch.from_numpy(rows), dim=1).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(rows), axis=1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 1, 1, 3, 2, 0])
    # and 1 - softmax of such rows is NaN in both
    got = 1.0 - torch.softmax(torch.from_numpy(rows), dim=1)[:, -1]
    want = 1.0 - np.asarray(jax.nn.softmax(jnp.asarray(rows), axis=1))[:, -1]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _kernels(dense_mass):
    """JAX and port SA on eight schools, built once per module (the JAX
    step compiles once)."""
    cfg = dict(dense_mass=dense_mass)
    return (jsa(jamt.eight_schools_noncentered(), JSAConfig(**cfg)),
            amt.sa(amt.eight_schools_noncentered(), amt.SAConfig(**cfg)))


@functools.lru_cache(maxsize=None)
def _jax_init(seed, C):
    return _kernels(True)[0].init(jax.random.PRNGKey(seed), n_chains=C)


def _jax_draws(keys, N, d):
    """The draws of the JAX step from its state's keys: (next keys, SADraws
    as numpy, the deletion keys)."""
    keys, draws, k_del = _jax_draws_jit(keys, N, d)
    return keys, tuple(np.array(a) for a in draws), k_del


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draws_jit(keys, N, d):
    keys, keys_step = split_keys(keys, 2)

    def one(key):
        _, k_prop, k_del, k_pick = jax.random.split(key, 4)
        return (jax.random.normal(k_prop, (d,)),
                jax.random.gumbel(k_del, (N + 1,)),
                jax.random.randint(k_pick, (), 0, N), k_del)

    eps, gumbel, pick, k_del = jax.vmap(one)(keys_step)
    return keys, (eps, gumbel, pick), k_del


def _tdraws(draws):
    eps, gumbel, pick = draws
    return amt.SADraws(torch.from_numpy(eps), torch.from_numpy(gumbel),
                       torch.from_numpy(pick.astype(np.int64)))


def _deleted(zs_old, zs_new):
    """Per chain, the index whose member was replaced, N for none."""
    changed = np.any(zs_old != zs_new, axis=-1)
    return np.where(changed.any(1), changed.argmax(1), zs_old.shape[1])


def _assert_states_close(got, want):
    for f in ("position", "potential_energy", "accept_prob",
              "mean_accept_prob"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    for f in ("zs", "pes", "loc", "scale"):
        np.testing.assert_allclose(getattr(got.adapt_state, f).numpy(),
                                   np.asarray(getattr(want.adapt_state, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert int(got.i) == int(want.i)
    assert not got.diverging.any()


@pytest.mark.parametrize("variant", ["dense", "diag", "inf_potential",
                                     "nan_refit"])
def test_step_matches_jax_on_injected_draws(variant):
    """One step from the same state with the JAX step's draws.  inf_potential:
    chain 0's ensemble holds a +inf potential.  nan_refit: chain 1's factor
    is far too small, so every leave-one-out factor is NaN (log_phi -> -inf),
    and a +inf potential makes its log weight -inf + inf = NaN: argmax
    deletes that member, the kept factor is NaN, and the guard refits it."""
    C = 5
    jk, tk = _kernels(variant != "diag")
    js = _jax_init(3, C)
    N, d = js.adapt_state.zs.shape[1:]
    a = js.adapt_state
    if variant == "diag":
        # the ensemble of the dense init, with its standard deviations
        a = a._replace(scale=jnp.sqrt(jnp.mean(
            (a.zs - a.loc[:, None]) ** 2, axis=1) + 1e-6))
    if variant in ("inf_potential", "nan_refit"):
        a = a._replace(pes=a.pes.at[0 if variant == "inf_potential" else 1,
                                    7].set(jnp.inf))
    if variant == "nan_refit":
        a = a._replace(scale=a.scale.at[1].set(0.01 * jnp.eye(d)))
    js = js._replace(adapt_state=a)

    _, draws, k_del = _jax_draws(js.rng_key, N, d)
    # the rebuilt Gumbel noise is jax.random.categorical's
    logits = jax.random.normal(jax.random.PRNGKey(9), (C, N + 1)) * 3.0
    want_j = jax.vmap(jax.random.categorical)(k_del, logits)
    np.testing.assert_array_equal(
        np.argmax(draws[1] + np.asarray(logits), axis=1), want_j)

    want = jk.step(js)
    ts = interop.sa_state_from_numpy(jax.tree.map(np.asarray, js))
    got = tk.step(ts, None, _tdraws(draws))
    _assert_states_close(got, want)
    zs0 = np.asarray(js.adapt_state.zs)
    np.testing.assert_array_equal(
        _deleted(zs0, got.adapt_state.zs.numpy()),
        _deleted(zs0, np.asarray(want.adapt_state.zs)))
    # the reported sample is the picked ensemble member
    np.testing.assert_array_equal(
        got.position.numpy(),
        got.adapt_state.zs.numpy()[np.arange(C), draws[2]])
    if variant == "inf_potential":
        assert _deleted(zs0, got.adapt_state.zs.numpy())[0] == 7
        assert np.isnan(got.accept_prob[0].item())
    if variant == "nan_refit":
        assert _deleted(zs0, got.adapt_state.zs.numpy())[1] == 7
        zs1 = got.adapt_state.zs[1].double()
        cen = zs1 - zs1.mean(0)
        want_cov = cen.T @ cen / N + 1e-6 * torch.eye(d, dtype=torch.float64)
        L = got.adapt_state.scale[1].double()
        np.testing.assert_allclose((L @ L.T).numpy(), want_cov.numpy(),
                                   rtol=1e-3, atol=1e-5)


def test_chained_replay_matches_jax_normwise():
    """20 steps from the converted JAX init state on the JAX draws."""
    C, steps = 5, 20
    jk, tk = _kernels(True)
    js = _jax_init(3, C)
    N, d = js.adapt_state.zs.shape[1:]
    ts = interop.sa_state_from_numpy(jax.tree.map(np.asarray, js))
    keys = js.rng_key
    for _ in range(steps):
        keys, draws, _ = _jax_draws(keys, N, d)
        ts = tk.step(ts, None, _tdraws(draws))
        js = jk.step(js)
    assert int(ts.i) == int(js.i) == steps
    pairs = [(ts.position, js.position),
             (ts.mean_accept_prob, js.mean_accept_prob),
             *zip(ts.adapt_state, js.adapt_state)]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(want).all() and np.isfinite(got).all()
        bound = ATOL + RTOL * np.max(np.abs(want))
        assert np.max(np.abs(got - want)) <= bound


def test_init_takes_the_jax_adapt_state():
    C = 5
    _, tk = _kernels(True)
    js = jax.tree.map(np.asarray, _jax_init(3, C))
    converted = interop.sa_state_from_numpy(js)
    ts = tk.init(None, n_chains=C, position=np.array(js.position),
                 adapt_state=converted.adapt_state)
    np.testing.assert_array_equal(ts.position.numpy(), js.position)
    np.testing.assert_allclose(ts.potential_energy.numpy(),
                               js.potential_energy, rtol=1e-6)
    for got, want in zip(ts.adapt_state, js.adapt_state):
        np.testing.assert_array_equal(got.numpy(), want)
    assert ts.diverging.dtype == torch.bool and int(ts.i) == 0
    # the port's own init: (loc, scale) are the ensemble's, as in JAX
    own = tk.init(_gen(0), n_chains=C)
    zs = own.adapt_state.zs.double()
    np.testing.assert_allclose(own.adapt_state.loc.numpy(),
                               zs.mean(1).numpy(), rtol=1e-5, atol=1e-5)
    assert own.adapt_state.zs.shape == js.adapt_state.zs.shape


@pytest.mark.parametrize("dense_mass", [True, False])
def test_step_reads_nothing_on_the_host(dense_mass):
    """The precondition of the CUDA graph: the step passes checked_step."""
    tk = amt.sa(amt.eight_schools_noncentered(),
                amt.SAConfig(dense_mass=dense_mass, adapt_state_size=16))
    g = _gen(1)
    s = tk.init(g, n_chains=3)
    s = checked_step(tk, s, g)
    assert int(s.i) == 1 and tk.graph_step


def test_mcmc_diagnostics_and_warmup_rebuild():
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.sa(t, amt.SAConfig(adapt_state_size=16)),
                    num_warmup=10, num_samples=20, thinning=2, n_chains=2)
    mcmc.run(_gen(2))
    assert mcmc.kernel.config.num_warmup == 10
    assert mcmc.get_samples()["theta_base"].shape == (20, 8)
    # JAX's MCMC.diagnostics_str formats an SA state as
    # f"Acceptance rate: {ap:.2f}" (adaptive_mcmc_tpu/infer/mcmc.py)
    ap = float(mcmc.last_state.mean_accept_prob.mean())
    assert mcmc.diagnostics_str() == f"Acceptance rate: {ap:.2f}"


def test_ensemble_stats_track_set():
    """loc and scale stay the mean and chol(cov) of the ensemble through
    the incremental updates (test_sa.py:10-28)."""
    k = amt.sa(amt.std_normal(3), amt.SAConfig(adapt_state_size=24))
    g = _gen(0)
    st = k.init(g, n_chains=2)
    for _ in range(30):
        st = k.step(st, g)
    zs = st.adapt_state.zs.double()
    loc = zs.mean(1)
    np.testing.assert_allclose(st.adapt_state.loc.numpy(), loc.numpy(),
                               rtol=1e-3, atol=1e-3)
    for c in range(2):
        cen = zs[c] - loc[c]
        L = st.adapt_state.scale[c].double()
        np.testing.assert_allclose((L @ L.T).numpy(),
                                   (cen.T @ cen / zs.shape[1]).numpy(),
                                   rtol=0.05, atol=5e-3)


def test_posterior_moments_std_normal():
    """std_normal(2) (test_sa.py:45-57), at 64 chains, a 32-member
    ensemble and fewer steps."""
    k = amt.sa(amt.std_normal(2), amt.SAConfig(adapt_state_size=32))
    samples, _, last = amt.run_mcmc(k, _gen(3), num_warmup=200,
                                    num_samples=300, n_chains=64)
    flat = samples.reshape(-1, 2).double()
    np.testing.assert_allclose(flat.mean(0).numpy(), np.zeros(2), atol=0.12)
    np.testing.assert_allclose(flat.std(0).numpy(), np.ones(2), atol=0.12)
    assert 0.02 < float(last.mean_accept_prob.mean()) <= 1.0
