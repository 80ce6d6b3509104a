"""Port parity for the ASSS kernel: the stereographic maps and the lockstep
step against JAX on replayed draws, the statistical checks of test_asss.py
on the port, the ASSS state crossing between the packages, and the
driver's diagnostics string.

Tolerances: the maps at rtol 1e-5, atol 1e-6 (a triangular solve and a
matvec in two float32 libraries); one lockstep step at rtol 1e-4,
atol 1e-5, elementwise: the step projects, evaluates the transformed
potential on every shrinkage trip and maps back through the whitening
factor, and the two packages round each of these differently in float32.
Per-chain trip counts must be equal."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu.kernels.asss import (  # noqa: E402
    ASSSAdaptState as JAdaptState,
    ASSSState as JState,
    stereographic_inverse as j_inverse,
    stereographic_project as j_project,
)
from adaptive_mcmc_tpu.kernels.base import split_keys  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.kernels.asss import (  # noqa: E402
    stereographic_inverse,
    stereographic_project,
)

RTOL, ATOL = 1e-4, 1e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_maps_match_jax_round_trip_and_sphere():
    """d = 5, C = 7 (test_asss.py:16-31): both maps against JAX, the round
    trip, and ||z|| = 1."""
    d, C = 5, 7
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(C, d)) * 3.0).astype(np.float32)
    loc = rng.normal(size=(C, d)).astype(np.float32)
    a = rng.normal(size=(C, d, d)) * 0.2
    scale = np.linalg.cholesky(np.einsum("cij,ckj->cik", a, a) + np.eye(d)) \
        .astype(np.float32)
    tx, tloc, tscale = map(torch.from_numpy, (x, loc, scale))
    z = stereographic_project(tx, tloc, tscale)
    jz = j_project(*map(jnp.asarray, (x, loc, scale)))
    assert z.shape == (C, d + 1)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(torch.sum(z * z, dim=-1).numpy(), np.ones(C),
                               rtol=1e-5)
    x2 = stereographic_inverse(z, tloc, tscale)
    jx2 = j_inverse(jnp.asarray(z.numpy()), jnp.asarray(loc),
                    jnp.asarray(scale))
    np.testing.assert_allclose(x2.numpy(), np.asarray(jx2), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-3, atol=1e-4)


@functools.partial(jax.jit, static_argnums=1)
def _jax_step_draws(rng_key, d):
    """The draws of one JAX lockstep step, rebuilt from its key splits
    (kernels/asss.py:207 and _shrinkage_batched): velocity normals,
    level and angle uniforms, and the uniform of each shrinkage trip."""
    trips = jamt.ASSSConfig().max_shrinkage_iters
    _, keys_v, keys_t, keys_shrink = split_keys(rng_key, 4)
    velocity = jax.vmap(lambda k: jax.random.normal(k, (d + 1,)))(keys_v)
    u_level = jax.vmap(jax.random.uniform)(keys_t)
    keys_init, keys_loop = split_keys(keys_shrink, 2)
    u_theta = jax.vmap(jax.random.uniform)(keys_init)

    def trip(keys, _):
        keys_smp, keys_next = split_keys(keys, 2)
        return keys_next, jax.vmap(jax.random.uniform)(keys_smp)

    _, u_shrink = jax.lax.scan(trip, keys_loop, None, length=trips)
    return velocity, u_level, u_theta, u_shrink


def _fields(state):
    a = state.adapt_state
    return {"position": state.position,
            "potential_energy": state.potential_energy,
            "as_change": state.as_change, "loc": a.loc, "scale": a.scale}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_jax_on_replayed_draws(seed):
    """Three lockstep steps on eight-schools (C = 8) across the warmup
    boundary, each taken by the port from the converted JAX state with the
    JAX step's own draws: equal trip counts per chain, equal states."""
    C, T = 8, 3
    jk = jamt.asss(jm.eight_schools_noncentered(),
                   jamt.ASSSConfig(num_warmup=2))
    tk = amt.asss(amt.eight_schools_noncentered(),
                  amt.ASSSConfig(num_warmup=2))
    js = jk.init(jax.random.PRNGKey(seed), n_chains=C)
    for t in range(T):
        draws = amt.ASSSDraws(*(torch.from_numpy(np.array(a))
                                for a in _jax_step_draws(js.rng_key, 10)))
        ts = interop.asss_state_from_numpy(jax.tree.map(np.asarray, js))
        js_new, jtrips = jk.probe(js, 1)
        got, trips = tk.probe(ts, 1, draws=[draws])
        np.testing.assert_array_equal(trips.numpy(), np.asarray(jtrips),
                                      err_msg=f"step {t} trips")
        assert int(got.i) == int(js_new.i) == t + 1
        want = _fields(jax.tree.map(np.asarray, js_new))
        for name, g in _fields(interop.asss_state_to_numpy(got)).items():
            np.testing.assert_allclose(g, want[name], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t} {name}")
        one = tk.step(ts, draws=draws)
        np.testing.assert_array_equal(one.position.numpy(),
                                      got.position.numpy())
        js = js_new


def test_injected_shrink_rows_must_cover_the_trips():
    """A target that is +inf off the origin rejects every angle, so the
    first trip already needs a row of u_shrink."""
    wall = amt.Target(
        name="wall", dim=2,
        potential_fn=lambda x: torch.where(
            torch.sum(x * x, dim=-1) < 1e-12, 0.0, float("inf")))
    tk = amt.asss(wall)
    st = tk.init(n_chains=3, position=torch.zeros(2))
    draws = amt.ASSSDraws(torch.randn(3, 3), torch.rand(3),
                          torch.full((3,), 0.3), torch.rand(0, 3))
    with pytest.raises(ValueError, match="u_shrink"):
        tk.step(st, draws=draws)


def test_adaptation_recursion():
    """test_asss.py:65-86: loc, the covariance of the new factor and
    as_change after the second step."""
    k = amt.asss(amt.std_normal(2))
    g = _gen(5)
    st1 = k.step(k.init(g, n_chains=1), g)
    st2 = k.step(st1, g)
    gamma = 2.0 ** (-2.0 / 3.0)
    loc1, S1 = st1.adapt_state.loc[0], st1.adapt_state.scale[0]
    loc2, S2 = st2.adapt_state.loc[0], st2.adapt_state.scale[0]
    delta = st2.position[0] - loc1
    np.testing.assert_allclose(loc2.numpy(), (loc1 + gamma * delta).numpy(),
                               rtol=1e-5)
    want_cov = (1 - gamma) * (S1 @ S1.T) + gamma * torch.outer(delta, delta)
    np.testing.assert_allclose((S2 @ S2.T).numpy(), want_cov.numpy(),
                               rtol=1e-4, atol=1e-5)
    want_change = torch.linalg.vector_norm(loc2 - loc1) \
        + torch.linalg.matrix_norm(S2 - S1)
    np.testing.assert_allclose(float(st2.as_change[0]), float(want_change),
                               rtol=1e-4)


def test_posterior_moments_std_normal():
    k = amt.asss(amt.std_normal(2), amt.ASSSConfig(num_warmup=500))
    samples, _, _ = amt.run_mcmc(k, _gen(6), num_warmup=500,
                                 num_samples=2000, n_chains=32)
    flat = samples.reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(0).numpy(), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(flat.std(0).numpy(), np.ones(2), atol=0.08)


def test_mixture_both_modes_visited():
    k = amt.asss(amt.gaussian_mixture_1d(), amt.ASSSConfig(num_warmup=200))
    samples, _, _ = amt.run_mcmc(k, _gen(7), num_warmup=200,
                                 num_samples=800, n_chains=32)
    frac_right = float((samples.reshape(-1) > 0).float().mean())
    assert 0.3 < frac_right < 0.7, frac_right


def test_step_n_matches_lockstep_statistically():
    """test_asss.py:113-137 with 256 chains over 400 steps: the pipelined
    step_n and the lockstep step sample the same distribution."""
    k = amt.asss(amt.std_normal(3))
    s0 = k.init(_gen(3), n_chains=256)
    g = _gen(4)
    s_sync = s0
    for _ in range(400):
        s_sync = k.step(s_sync, g)
    s_async = k.step_n(s0, 400, _gen(5))
    assert int(s_async.i) == int(s_sync.i) == 400
    for tag, s in (("sync", s_sync), ("async", s_async)):
        pos = s.position.numpy()
        assert abs(pos.mean()) < 0.15, (tag, pos.mean())
        assert abs(pos.std() - 1.0) < 0.15, (tag, pos.std())
    np.testing.assert_allclose(s_sync.position.numpy().mean(axis=0),
                               s_async.position.numpy().mean(axis=0),
                               atol=0.2)


def test_step_n_single_step_invariance():
    """pi P = pi for one pipelined transition from exact target samples
    (test_asss.py:140-163), by a KS test."""
    import scipy.stats

    k = amt.asss(amt.std_normal(1), amt.ASSSConfig(adapt=False))
    n = 20_000
    exact = torch.from_numpy(
        np.random.default_rng(11).normal(size=(n, 1)).astype(np.float32))
    frozen = amt.ASSSAdaptState(loc=torch.zeros(n, 1),
                                scale=torch.ones(n, 1, 1))
    state = k.init(n_chains=n, position=exact, adapt_state=frozen)
    out = k.step_n(state, 1, _gen(12))
    ks = scipy.stats.kstest(out.position[:, 0].numpy(), "norm")
    assert ks.pvalue > 1e-3, ks
    assert not torch.equal(out.position, exact)


def test_collect_n_matches_step_n():
    """test_asss.py:166-195: collect_n runs the same machine as one step_n
    call, so the final state is equal and the last frame is the final
    state."""
    k = amt.asss(amt.eight_schools_noncentered(),
                 amt.ASSSConfig(num_warmup=10))
    state = k.step_n(k.init(_gen(3), n_chains=8), 10, _gen(4))
    want = k.step_n(state, 20, _gen(5))
    got, bufs = k.collect_n(state, n_frames=4, thinning=5,
                            generator=_gen(5))
    for name, w in _fields(want).items():
        np.testing.assert_array_equal(_fields(got)[name].numpy(), w.numpy(),
                                      err_msg=name)
    assert bufs["position"].shape == (8, 4, 10)
    assert bufs["potential_energy"].shape == (8, 4)
    assert bufs["as_change"].shape == (8, 4)
    np.testing.assert_array_equal(bufs["position"][:, -1].numpy(),
                                  got.position.numpy())
    np.testing.assert_array_equal(bufs["potential_energy"][:, -1].numpy(),
                                  got.potential_energy.numpy())
    np.testing.assert_array_equal(bufs["as_change"][:, -1].numpy(),
                                  got.as_change.numpy())
    assert torch.isfinite(bufs["position"]).all()
    assert not (bufs["position"] == 0.0).all(dim=-1).any()


def test_fused_and_pipelined_drivers_agree_on_the_cpu():
    """On the CPU ASSSConfig(fused=True) runs K3's plain version: the same
    machine as the pipelined step_n with the same draws, so equal states."""
    t = amt.eight_schools_noncentered()
    k_pipe = amt.asss(t, amt.ASSSConfig(num_warmup=5))
    k_fused = amt.asss(t, amt.ASSSConfig(num_warmup=5, fused=True))
    state = k_pipe.init(_gen(8), n_chains=6)
    a = k_pipe.step_n(state, 15, _gen(9))
    b = k_fused.step_n(state, 15, _gen(9))
    for name, w in _fields(a).items():
        np.testing.assert_array_equal(_fields(b)[name].numpy(), w.numpy(),
                                      err_msg=name)


def test_probe_replays_step():
    """test_asss.py:254-268: probe advances exactly as step does and
    returns per-chain mean trips in [0, max_shrinkage_iters]."""
    k = amt.asss(amt.eight_schools_noncentered())
    state = k.init(_gen(3), n_chains=16)
    g = _gen(4)
    s_step = k.step(k.step(state, g), g)
    s_probe, mean_trips = k.probe(state, 2, _gen(4))
    np.testing.assert_array_equal(s_step.position.numpy(),
                                  s_probe.position.numpy())
    assert mean_trips.shape == (16,)
    assert bool(((mean_trips >= 0) & (mean_trips <= 50)).all())


def test_asss_state_crosses_unchanged():
    """JAX ASSSState -> numpy -> port -> numpy, every field unchanged (the
    JAX rng_key has no counterpart)."""
    jk = jamt.asss(jm.eight_schools_noncentered())
    js = jk.step(jk.init(jax.random.PRNGKey(4), n_chains=5))
    jn = jax.tree.map(np.asarray, js)
    ts = interop.asss_state_from_numpy(jn)
    assert ts.position.dtype == torch.float32 and ts.i.dtype == torch.int32
    back = interop.asss_state_to_numpy(ts)
    assert int(back.i) == int(jn.i) == 1
    want = _fields(jn)
    for name, got in _fields(back).items():
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_diagnostics_str_matches_jax_format():
    """An ASSS state has no acceptance rate: the driver reports the
    iteration and mean potential, in the JAX package's format."""
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.asss(t), num_warmup=10, num_samples=20,
                    n_chains=4)
    mcmc.run(_gen(0))
    got = mcmc.diagnostics_str()
    n = interop.asss_state_to_numpy(mcmc.last_state)
    jmcmc = jamt.MCMC(jamt.asss(jm.eight_schools_noncentered()),
                      num_warmup=10, num_samples=20, n_chains=4)
    jmcmc.last_state = JState(
        i=jnp.asarray(n.i), position=jnp.asarray(n.position),
        potential_energy=jnp.asarray(n.potential_energy),
        adapt_state=JAdaptState(jnp.asarray(n.adapt_state.loc),
                                jnp.asarray(n.adapt_state.scale)),
        as_change=jnp.asarray(n.as_change), rng_key=None)
    assert got == jmcmc.diagnostics_str()
    assert got.startswith("Iteration: 30, Potential Energy: ")


def test_run_mcmc_refuses_injected_draws_for_asss():
    k = amt.asss(amt.eight_schools_noncentered())
    with pytest.raises(ValueError, match="injected"):
        amt.run_mcmc(k, _gen(0), 0, 2, n_chains=1,
                     noise=torch.zeros(2, 1, 10), unif=torch.zeros(2, 1))


def test_lockstep_run_mcmc_through_step():
    """run_mcmc drives a kernel without step_n through its lockstep step,
    with thinning and extras."""
    k = amt.asss(amt.eight_schools_noncentered(),
                 amt.ASSSConfig(num_warmup=4))
    lock = dataclasses.replace(k, step_n=None, collect_n=None)
    samples, extras, last = amt.run_mcmc(
        lock, _gen(1), 4, 12, thinning=3, n_chains=3,
        extra_fields=("potential_energy",))
    assert samples.shape == (4, 3, 10) and int(last.i) == 16
    np.testing.assert_allclose(
        extras["potential_energy"][-1].numpy(),
        amt.eight_schools_noncentered().potential_fn(samples[-1]).numpy(),
        rtol=1e-6)
