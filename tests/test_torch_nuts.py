"""Port parity for NUTS (adaptive_mcmc_tpu_torch/kernels/nuts.py) against
the JAX kernel, exactly where the math is deterministic: the warmup
schedule, the mass-matrix algebra, init with injected search momenta, one
lockstep step on the JAX step's own draws, the pipelined step_n and
collect_n on the JAX machine's own trip uniforms, the state crossing
between the packages, and the driver's diagnostics string.

Tolerances: the schedule is equal; the algebra rtol 1e-6 (1e-5 for the
dense triangular solve); init and one step rtol 1e-4, atol 1e-5 (the SA
step's, tests/test_torch_sa.py), with num_steps and diverging equal.  The
machine's runs chain tens of leapfrogs, so they are compared normwise at
the chained tolerance of tests/test_torch_asss_fused.py, num_steps equal,
over at most four transitions: XLA's erfinv and torch's differ by up to
5e-6 relative, and leapfrog trajectories amplify that within a few
transitions (a U-turn decision can flip after about ten), so longer runs
are compared one transition per call from the JAX state.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu.kernels.base import split_keys  # noqa: E402
from adaptive_mcmc_tpu.models.base import SiteSpec as JSite  # noqa: E402
from adaptive_mcmc_tpu.models.base import Target as JTarget  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.models.base import SiteSpec  # noqa: E402
from adaptive_mcmc_tpu_torch.models.base import Target  # noqa: E402

# the modules (each package's kernels/__init__ exports the function nuts)
jn = importlib.import_module("adaptive_mcmc_tpu.kernels.nuts")
tn = importlib.import_module("adaptive_mcmc_tpu_torch.kernels.nuts")

RTOL, ATOL = 1e-4, 1e-5
CHAIN_RTOL, CHAIN_ATOL = 2e-4, 2e-5
WARMUP = 20      # windows: in_window[3:18], one window closing at 17
DEPTH = 5


@pytest.mark.parametrize("num_warmup",
                         [0, 1, 19, 20, 99, 100, 150, 400, 500, 700, 1000,
                          1001])
def test_warmup_schedule_equals_jax(num_warmup):
    got = tn.build_warmup_schedule(num_warmup)
    want = jn.build_warmup_schedule(num_warmup)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_checkpoint_tables():
    slot, trail = tn.checkpoint_tables(DEPTH)
    for n in range(1 << DEPTH):
        assert slot[n] == bin(n >> 1).count("1")
        t, m = 0, n
        while m & 1:
            t, m = t + 1, m >> 1
        assert trail[n] == t


def _mass(dense, C, d, rng):
    if dense:
        a = rng.normal(size=(C, d, d)) * 0.3
        inv = np.einsum("cij,ckj->cik", a, a) + np.eye(d)
        return inv.astype(np.float32), np.linalg.cholesky(inv).astype(
            np.float32)
    inv = rng.uniform(0.3, 3.0, size=(C, d)).astype(np.float32)
    return inv, np.sqrt(inv)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
@pytest.mark.parametrize("helper", ["velocity", "kinetic", "momentum",
                                    "turning", "velocity_rows"])
def test_mass_matrix_algebra_matches_jax(helper, dense):
    C, d, k = 7, 5, 4
    rng = np.random.default_rng(11)
    inv, chol = _mass(dense, C, d, rng)
    r1, r2, rho = (rng.normal(size=(C, d)).astype(np.float32)
                   for _ in range(3))
    R = rng.normal(size=(C, k, d)).astype(np.float32)
    T = torch.from_numpy
    if helper == "velocity":
        got = tn._velocity(T(inv), T(r1))
        want = jax.vmap(jn._velocity)(inv, r1)
    elif helper == "kinetic":
        got = tn._kinetic(T(inv), T(r1))
        want = jax.vmap(jn._kinetic)(inv, r1)
    elif helper == "momentum":
        keys = jax.random.split(jax.random.PRNGKey(3), C)
        eps = np.array(jax.vmap(lambda q: jax.random.normal(q, (d,)))(keys))
        got = tn._sample_momentum(T(eps), T(chol))
        want = jax.vmap(jn._sample_momentum, in_axes=(0, 0, None))(
            keys, chol, d)
    elif helper == "turning":
        got = tn._is_turning(T(inv), T(r1), T(r2), T(rho))
        want = jax.vmap(jn._is_turning)(inv, r1, r2, rho)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    else:
        got = tn._velocity_rows(T(inv), T(R))
        want = jax.vmap(jn._velocity_rows)(inv, R)
    rtol = 1e-5 if helper == "momentum" and dense else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-7)


def test_logaddexp_and_nan_comparison_as_jax():
    """The edge values of the multinomial draw: logaddexp(-inf, -inf) is
    -inf in both, exp(-inf - -inf) is NaN, and u < NaN is false."""
    ninf = float("-inf")
    a = np.array([ninf, ninf, 0.0, 1.0], np.float32)
    b = np.array([ninf, 2.0, ninf, np.inf], np.float32)
    got = torch.logaddexp(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jnp.logaddexp(a, b))
    np.testing.assert_array_equal(got.numpy(), want)
    p = torch.exp(torch.from_numpy(b) - got)
    assert torch.isnan(p[0]) and not bool(torch.tensor(0.3) < p[0])


# ---------------------------------------------------------------------------
# Targets of both packages
# ---------------------------------------------------------------------------

_MVN_L = np.array([[1.0, 0.0, 0.0], [0.9, 0.6, 0.0], [-0.3, 0.2, 0.5]],
                  np.float32)


def _nan_region_pair():
    """A Gaussian whose potential (and gradient) is NaN past x0 = 1.5."""
    def jpot(x):
        return 0.5 * jnp.sum(x * x) - 2.0 * jnp.sqrt(1.5 - x[0])

    def tpot(x):
        return 0.5 * torch.sum(x * x, dim=-1) - 2.0 * torch.sqrt(1.5 - x[:, 0])

    return (JTarget("nan_region", 3, jpot, (JSite("x", 3, (3,)),)),
            Target(name="nan_region", dim=3, potential_fn=tpot,
                   sites=(SiteSpec("x", 3, (3,)),)))


def _targets(name):
    if name == "eight_schools":
        return (jamt.eight_schools_noncentered(),
                amt.eight_schools_noncentered())
    if name == "mvn_dense":
        return (jamt.models.mvn(np.zeros(3, np.float32), _MVN_L),
                amt.mvn(np.zeros(3, np.float32), _MVN_L))
    if name in ("std_normal_dense", "max_depth"):
        return jamt.models.std_normal(4), amt.std_normal(4)
    return _nan_region_pair()


_CONFIGS = {
    "eight_schools": dict(),
    "mvn_dense": dict(dense_mass=True),
    "std_normal_dense": dict(dense_mass=True),
    "nan_region": dict(),
    "max_depth": dict(step_size=1e-3, adapt_step_size=False,
                      adapt_mass_matrix=False),
}


@functools.lru_cache(maxsize=None)
def _kernels(name, num_warmup=WARMUP):
    jt, tt = _targets(name)
    cfg = dict(max_tree_depth=DEPTH, num_warmup=num_warmup, **_CONFIGS[name])
    return (jn.nuts(jt, jn.NUTSConfig(**cfg)),
            tn.nuts(tt, tn.NUTSConfig(**cfg)))


def _start(name, C, seed=0):
    rng = np.random.default_rng(seed)
    d = _targets(name)[0].dim
    x = rng.uniform(-1.5, 1.5, size=(C, d)).astype(np.float32)
    if name == "nan_region":
        x[:, 0] = rng.uniform(0.6, 1.3, size=C)  # near the NaN region
    return x


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_state_close(got, want, rtol=RTOL, atol=ATOL):
    for f in ("position", "potential_energy", "pe_grad", "mean_accept_prob"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f)
    flat_g = jax.tree.leaves(_to_np(interop.nuts_state_to_numpy(
        got).adapt_state))
    flat_w = jax.tree.leaves(_to_np(want.adapt_state))
    for k, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"adapt leaf {k}")
    assert int(got.i) == int(want.i)


@pytest.mark.parametrize("name", ["eight_schools", "mvn_dense"])
def test_init_matches_jax_with_injected_search_momenta(name):
    C = 16
    jk, tk = _kernels(name)
    key = jax.random.PRNGKey(7)
    x = _start(name, C)
    want = jk.init(key, n_chains=C, position=jnp.asarray(x))
    key_eps = jax.random.split(key, 3)[2]
    d = x.shape[1]
    mom = np.array(jax.vmap(lambda q: jax.random.normal(q, (d,)))(
        jax.random.split(key_eps, C)))
    got = tk.init(None, n_chains=C, position=x, momentum=torch.from_numpy(mom))
    a, b = got.adapt_state, want.adapt_state
    np.testing.assert_allclose(torch.exp(a.da.log_eps).numpy(),
                               np.exp(np.asarray(b.da.log_eps)), rtol=RTOL)
    np.testing.assert_array_equal(a.inv_mass.numpy(), np.asarray(b.inv_mass))
    np.testing.assert_array_equal(a.chol_inv_mass.numpy(),
                                  np.asarray(b.chol_inv_mass))
    _assert_state_close(got, want)


# ---------------------------------------------------------------------------
# The lockstep step on the JAX step's draws
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def _lockstep_draws(rng_key, d, depth):
    """Every draw of one JAX transition per chain, from its state's keys
    (kernels/nuts.py: split_keys, then _single_transition's splits; a
    masked chain does not advance its key, so doubling k and leaf n of a
    chain read entry k and n)."""
    _, keys_tr = split_keys(rng_key, 2)

    def one(key):
        key, k_mom = jax.random.split(key)
        mom = jax.random.normal(k_mom, (d,))
        u_dir, u_bias, u_leaf = [], [], []
        for _ in range(depth):
            key, k_dir, k_sub, k_bias = jax.random.split(key, 4)
            u_dir.append(jax.random.uniform(k_dir))
            u_bias.append(jax.random.uniform(k_bias))
            leaves, s = [], k_sub
            for _ in range(1 << (depth - 1)):
                s, k_acc = jax.random.split(s)
                leaves.append(jax.random.uniform(k_acc))
            u_leaf.append(jnp.stack(leaves))
        return mom, jnp.stack(u_dir), jnp.stack(u_bias), jnp.stack(u_leaf)

    return jax.vmap(one)(keys_tr)


@functools.lru_cache(maxsize=None)
def _jax_states(name, C=16):
    """The JAX lockstep run from a fixed start, at every step up to 25."""
    jk, _ = _kernels(name)
    s = jk.init(jax.random.PRNGKey(1), n_chains=C,
                position=jnp.asarray(_start(name, C, seed=1)))
    out = [s]
    for _ in range(25):
        s = jk.step(s)
        out.append(s)
    return out


@pytest.mark.parametrize("at", [10, 17, 25],
                         ids=["in_window", "window_close", "after_warmup"])
@pytest.mark.parametrize("name", ["eight_schools", "mvn_dense",
                                  "std_normal_dense", "nan_region",
                                  "max_depth"])
def test_step_matches_jax_on_injected_draws(name, at):
    jk, tk = _kernels(name)
    js = _jax_states(name)[at]
    want = _jax_states(name)[at + 1] if at < 25 else jk.step(js)
    d = js.position.shape[1]
    draws = tn.NUTSDraws(*(torch.from_numpy(np.array(a)) for a in
                           _lockstep_draws(js.rng_key, d, DEPTH)))
    got = tk.step(interop.nuts_state_from_numpy(_to_np(js)), None, draws)
    np.testing.assert_array_equal(got.num_steps.numpy(),
                                  np.asarray(want.num_steps))
    np.testing.assert_array_equal(got.diverging.numpy(),
                                  np.asarray(want.diverging))
    _assert_state_close(got, want)
    if name == "max_depth":
        assert (got.num_steps == (1 << DEPTH) - 1).all()
    if name == "nan_region" and at == 10:
        # some trajectories ran into the NaN region and diverged
        assert int(want.num_steps.min()) < int(want.num_steps.max())


def test_nan_region_run_diverges_as_jax():
    """Over the first 25 steps of the NaN-region run, the port's step on
    the JAX draws takes the JAX tree sizes every time, and some leapfrog
    met the NaN potential (a tree closed by divergence)."""
    jk, tk = _kernels("nan_region")
    states = _jax_states("nan_region")
    saw_short = False
    for js, want in zip(states[:-1], states[1:]):
        draws = tn.NUTSDraws(*(torch.from_numpy(np.array(a)) for a in
                               _lockstep_draws(js.rng_key, 3, DEPTH)))
        got = tk.step(interop.nuts_state_from_numpy(_to_np(js)), None,
                      draws)
        np.testing.assert_array_equal(got.num_steps.numpy(),
                                      np.asarray(want.num_steps))
        saw_short |= bool((got.num_steps < 3).any())
    assert saw_short


# ---------------------------------------------------------------------------
# The pipelined machine on the JAX machine's trip uniforms
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def _trip_uniforms(rng_key, d, rows):
    """(rows, 3 + d, C): row 0 the opening draw, row s the s-th trip's
    (kernels/nuts.py _drive: split_keys(rng_key, 2), then split_keys per
    trip; a chain done with the call never draws again, so its rows after
    that are never read)."""
    keys, k0 = split_keys(rng_key, 2)
    unif = jax.vmap(lambda k: jax.random.uniform(k, (3 + d,)))

    def body(keys, _):
        keys, kd = split_keys(keys, 2)
        return keys, unif(kd).T

    _, rest = jax.lax.scan(body, keys, None, length=rows - 1)
    return jnp.concatenate([unif(k0).T[None], rest])


def _assert_normwise(got, want, err=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, err
    assert np.isfinite(got).all() and np.isfinite(want).all(), err
    bound = CHAIN_ATOL + CHAIN_RTOL * np.max(np.abs(want))
    worst = np.max(np.abs(got - want))
    assert worst <= bound, f"{err}: max abs error {worst} > {bound}"


def _assert_machine_close(got, want):
    np.testing.assert_array_equal(got.num_steps.numpy(),
                                  np.asarray(want.num_steps))
    np.testing.assert_array_equal(got.diverging.numpy(),
                                  np.asarray(want.diverging))
    assert int(got.i) == int(want.i)
    g = jax.tree.leaves(_to_np(interop.nuts_state_to_numpy(got)))
    w = jax.tree.leaves(_to_np(want._replace(rng_key=None)))
    for k, (a, b) in enumerate(zip(g, w)):
        _assert_normwise(a, b, f"leaf {k}")


@functools.lru_cache(maxsize=None)
def _machine_start(name, at, C=8):
    jk, _ = _kernels(name)
    s = jk.init(jax.random.PRNGKey(4), n_chains=C,
                position=jnp.asarray(_start(name, C, seed=4)))
    return jk.step_n(s, at) if at else s


@pytest.mark.parametrize("name,at", [
    ("eight_schools", 0), ("eight_schools", 16), ("mvn_dense", 16),
    ("nan_region", 16), ("max_depth", 0)],
    ids=["from_init", "across_window_end", "dense_across_window_end",
         "nan_region", "max_depth"])
def test_step_n_matches_jax_on_replayed_trip_draws(name, at):
    """Three transitions in one call, the chains pipelined on their own
    clocks (from i = 16 the window closing at 17 falls inside the call)."""
    jk, tk = _kernels(name)
    js = _machine_start(name, at)
    want = jk.step_n(js, 3)
    d = js.position.shape[1]
    unif = torch.from_numpy(np.array(_trip_uniforms(js.rng_key, d, 1200)))
    got = tk.step_n(interop.nuts_state_from_numpy(_to_np(js)), 3,
                    unif=unif)
    _assert_machine_close(got, want)


@pytest.mark.parametrize("name", ["eight_schools", "mvn_dense"])
def test_step_n_transitions_across_window_end_match_jax(name):
    """12 transitions from i = 10 across the window end at 17, one call
    each from the JAX state on the JAX trip draws: every one at the step's
    tolerance.  (One call of 12 transitions is not compared: the port's
    erfinv differs from XLA's by up to 5e-6 relative, and leapfrog
    trajectories amplify that to 1e-3 within a few transitions.)"""
    jk, tk = _kernels(name)
    js = _machine_start(name, 10)
    for _ in range(12):
        d = js.position.shape[1]
        unif = torch.from_numpy(np.array(_trip_uniforms(js.rng_key, d,
                                                          600)))
        got = tk.step_n(interop.nuts_state_from_numpy(_to_np(js)), 1,
                        unif=unif)
        js = jk.step_n(js, 1)
        np.testing.assert_array_equal(got.num_steps.numpy(),
                                      np.asarray(js.num_steps))
        _assert_state_close(got, js)
    assert int(js.i) == 22


def test_collect_n_frames_match_jax_on_replayed_trip_draws():
    """JAX's test_collect_n_matches_step_n on the JAX trip draws: the
    frames are each chain's thinned trajectory, as JAX records it."""
    jk, tk = _kernels("eight_schools")
    js = _machine_start("eight_schools", 20, C=6)
    want, wbuf = jk.collect_n(js, n_frames=2, thinning=2)
    unif = torch.from_numpy(np.array(_trip_uniforms(js.rng_key, 10,
                                                      1200)))
    got, bufs = tk.collect_n(interop.nuts_state_from_numpy(_to_np(js)), 2,
                             2, unif=unif)
    _assert_machine_close(got, want)
    assert bufs["position"].shape == (6, 2, 10)
    assert bufs["potential_energy"].shape == (6, 2)
    _assert_normwise(bufs["position"].numpy(), wbuf["position"])
    _assert_normwise(bufs["potential_energy"].numpy(),
                     wbuf["potential_energy"])


def test_injected_trip_draws_must_cover_the_machine():
    jk, tk = _kernels("eight_schools")
    js = _machine_start("eight_schools", 0)
    unif = torch.from_numpy(np.array(_trip_uniforms(js.rng_key, 10, 4)))
    with pytest.raises(ValueError, match="injected draws end"):
        tk.step_n(interop.nuts_state_from_numpy(_to_np(js)), 3, unif=unif)


@pytest.mark.parametrize("n_frames,thinning,warmup", [(4, 3, 20),
                                                      (24, 2, 30)],
                         ids=["matches_step_n", "many_frames"])
def test_collect_n_equals_step_n_bit_for_bit(n_frames, thinning, warmup):
    """JAX's test_collect_n_matches_step_n and
    test_collect_n_drift_window_engages: the final state equals step_n's
    bit for bit, the last frame is the final state, and every frame is
    written."""
    tk = amt.nuts(amt.eight_schools_noncentered(),
                  amt.NUTSConfig(num_warmup=warmup))
    C = 6 if n_frames == 4 else 8
    g = torch.Generator().manual_seed(5)
    state = tk.init(g, n_chains=C)
    state = tk.step_n(state, warmup, g)
    runs = []
    for collect in (False, True):
        g = torch.Generator().manual_seed(13)
        if collect:
            runs.append(tk.collect_n(state, n_frames, thinning, g))
        else:
            runs.append(tk.step_n(state, n_frames * thinning, g))
    want, (got, bufs) = runs
    for a, b in zip(jax.tree.leaves(interop.nuts_state_to_numpy(want)),
                    jax.tree.leaves(interop.nuts_state_to_numpy(got))):
        np.testing.assert_array_equal(a, b)
    assert bufs["position"].shape == (C, n_frames, 10)
    assert torch.equal(bufs["position"][:, -1], got.position)
    assert torch.equal(bufs["potential_energy"][:, -1],
                       got.potential_energy)
    assert torch.isfinite(bufs["position"]).all()
    assert not (bufs["position"] == 0.0).all(dim=-1).any()


def test_interop_round_trip():
    js = _to_np(_jax_states("mvn_dense")[17])
    ts = interop.nuts_state_from_numpy(js)
    assert ts.num_steps.dtype == torch.int32
    assert ts.diverging.dtype == torch.bool and ts.i.dtype == torch.int32
    back = interop.nuts_state_to_numpy(ts)
    want = jax.tree.leaves(js._replace(rng_key=None))
    got = jax.tree.leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_diagnostics_str_matches_jax_format():
    """JAX's MCMC.diagnostics_str formats a NUTS state's step size as
    exp(mean(da.log_eps)) (adaptive_mcmc_tpu/infer/mcmc.py)."""
    js = _jax_states("eight_schools")[25]
    jm = jamt.MCMC(_kernels("eight_schools")[0], num_warmup=0,
                   num_samples=1)
    jm.last_state = js
    tm = amt.MCMC(_kernels("eight_schools")[1], num_warmup=0, num_samples=1)
    tm.last_state = interop.nuts_state_from_numpy(_to_np(js))
    assert tm.diagnostics_str() == jm.diagnostics_str()
    assert "Step size" in tm.diagnostics_str()


def test_mcmc_rebuilds_nuts_with_the_drivers_warmup():
    t = amt.std_normal(2)
    mcmc = amt.MCMC(amt.nuts(t, amt.NUTSConfig(max_tree_depth=4)),
                    num_warmup=25, num_samples=10, thinning=2, n_chains=3)
    mcmc.run(torch.Generator().manual_seed(2))
    assert mcmc.kernel.config.num_warmup == 25
    assert mcmc.get_samples()["x"].shape == (15, 2)
    assert int(mcmc.last_state.i) == 35


def test_checkpointed_run_resumes_bit_for_bit(tmp_path):
    """A NUTS state (nested dual-averaging and Welford states) crosses the
    checkpointed driver: stopped after its first chunk and resumed under
    another seed, the run draws what the uninterrupted one does."""
    from adaptive_mcmc_tpu_torch.infer import run_mcmc_checkpointed
    k = amt.nuts(amt.std_normal(2),
                 amt.NUTSConfig(num_warmup=10, max_tree_depth=4))
    runs = []
    for stop_first, d in ((False, tmp_path / "a"), (True, tmp_path / "b")):
        if stop_first:
            run_mcmc_checkpointed(k, torch.Generator().manual_seed(1), 10,
                                  10, thinning=2, n_chains=4,
                                  checkpoint_dir=d, chunk_size=10)
        seed = 2 if stop_first else 1
        runs.append(run_mcmc_checkpointed(
            k, torch.Generator().manual_seed(seed), 10, 20, thinning=2,
            n_chains=4, checkpoint_dir=d, chunk_size=10))
    (want, _, wlast), (got, _, glast) = runs
    np.testing.assert_array_equal(got, want)
    for a, b in zip(jax.tree.leaves(interop.nuts_state_to_numpy(wlast)),
                    jax.tree.leaves(interop.nuts_state_to_numpy(glast))):
        np.testing.assert_array_equal(a, b)
