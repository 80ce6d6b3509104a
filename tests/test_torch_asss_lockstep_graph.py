"""ASSS's lockstep step in blocks of shrinkage trips, and its CUDA-graph
driver's logic on the CPU.

The step runs ``kernels/asss.py`` ``SHRINK_TRIPS`` masked trips per block
and reads the active mask once per block; a trip after a chain has landed
changes nothing, so the blocked step equals the loop that stops after the
last trip (``_per_trip_step`` below, the step as it was before blocks)
bit for bit on the same draws, and JAX's step at the parity tests'
rtol 1e-4, atol 1e-5 (``tests/test_torch_asss.py``).  A seeded
``sample_pnx`` reseeds before each step, so its rollouts do not depend on
the block size.  ``infer.mcmc.LockstepGraph`` drives the same parts from
CUDA graphs on the card; here its replays are stood in for by the parts
run again (``_capture`` monkeypatched), which holds the driver's order of
parts, reseeds and buffers to the eager loop bit for bit."""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu.kernels.base import split_keys  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.infer import mcmc as tmcmc  # noqa: E402
from adaptive_mcmc_tpu_torch.kernels.asss import (  # noqa: E402
    ASSSAdaptState,
    ASSSState,
    stereographic_inverse,
    stereographic_project,
)
from adaptive_mcmc_tpu_torch.kernels.base import (  # noqa: E402
    adaptation_lr,
    nan_to_inf,
)
from adaptive_mcmc_tpu_torch.ops.cholesky import (  # noqa: E402
    adaptive_scale_update,
)
from adaptive_mcmc_tpu_torch.ops.cuda.asss_fused import TWO_PI  # noqa: E402
from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402

tasss = importlib.import_module("adaptive_mcmc_tpu_torch.kernels.asss")
RTOL, ATOL = 1e-4, 1e-5
BLOCKS = (1, 3, tasss.SHRINK_TRIPS, 32)


def _per_trip_step(target, config, state, generator=None, draws=None):
    """The lockstep step with the shrinkage loop that stops after the last
    trip (its active mask read on the host every trip): the plain
    reference of the blocked step.  Returns (state, trips)."""
    d, potential = target.dim, target.potential_fn
    loc, scale = state.adapt_state
    x = state.position
    C, dev = x.shape[0], x.device
    if draws is None:
        velocity = torch.randn((C, d + 1), generator=generator, device=dev)
        u_level = torch.rand((C,), generator=generator, device=dev)
        u_theta = torch.rand((C,), generator=generator, device=dev)

        def u_shrink(k):
            return torch.rand((C,), generator=generator, device=dev)
    else:
        velocity, u_level, u_theta = (draws.velocity, draws.u_level,
                                      draws.u_theta)

        def u_shrink(k):
            return draws.u_shrink[k]
    sig = (scale + config.eps * torch.eye(d)) * (d ** 0.5)

    def tpe(z):
        return potential(stereographic_inverse(z, loc, sig)) \
            + d * torch.log(1.0 - z[:, -1])

    z = stereographic_project(x, loc, sig)
    v = velocity - torch.sum(velocity * z, dim=-1, keepdim=True) * z
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    t_pe = tpe(z) - torch.log(u_level)
    theta = u_theta * TWO_PI
    tmin, tmax = theta - TWO_PI, theta

    def is_bad(theta):
        zt = z * torch.cos(theta)[:, None] + v * torch.sin(theta)[:, None]
        return (nan_to_inf(tpe(zt)) > t_pe) | ((1.0 - zt[:, -1]) < config.eps)

    bad = is_bad(theta)
    iters = torch.zeros(C, dtype=torch.int32)
    k = 0
    while True:
        active = bad & (iters < config.max_shrinkage_iters)
        if not bool(active.any()):
            break
        tmin = torch.where(active & (theta < 0.0), theta, tmin)
        tmax = torch.where(active & (theta >= 0.0), theta, tmax)
        theta = torch.where(active, tmin + u_shrink(k) * (tmax - tmin), theta)
        iters = iters + active.to(torch.int32)
        bad = torch.where(active, is_bad(theta), bad)
        k += 1
    theta = torch.where(iters >= config.max_shrinkage_iters,
                        torch.zeros_like(theta), theta)
    z_f = z * torch.cos(theta)[:, None] + v * torch.sin(theta)[:, None]
    x_new = stereographic_inverse(z_f, loc, sig)
    pe_new = nan_to_inf(potential(x_new))
    if config.adapt:
        _, gamma = adaptation_lr(state.i, config.num_warmup, config.lr_decay)
        delta = x_new - loc
        loc_new = loc + gamma * delta
        scale_new = adaptive_scale_update(scale, delta, gamma.expand(C))
        as_change = torch.linalg.vector_norm(loc_new - loc, dim=-1) \
            + torch.linalg.matrix_norm(scale_new - scale)
        adapt = ASSSAdaptState(loc_new, scale_new)
    else:
        adapt, as_change = state.adapt_state, torch.zeros_like(pe_new)
    return ASSSState(state.i + 1, x_new, pe_new, adapt, as_change), iters


@functools.partial(jax.jit, static_argnums=1)
def _jax_step_draws(rng_key, d):
    """The draws of one JAX lockstep step from its key splits (as
    tests/test_torch_asss.py rebuilds them)."""
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


def _tensors(state):
    a = state.adapt_state
    return (state.i, state.position, state.potential_energy, a.loc, a.scale,
            state.as_change)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


@pytest.mark.parametrize("block", BLOCKS)
def test_blocked_step_on_injected_draws_equals_per_trip_loop_and_jax(
        monkeypatch, block):
    """Eight schools, 8 chains, three steps across the warmup boundary on
    JAX's replayed draws: the blocked step and probe equal the per-trip
    loop bit for bit (state and trips per chain) and JAX's step at rtol
    1e-4, atol 1e-5 with equal trips."""
    monkeypatch.setattr(tasss, "SHRINK_TRIPS", block)
    cfg = amt.ASSSConfig(num_warmup=2)
    tt = amt.eight_schools_noncentered()
    jk = jamt.asss(jm.eight_schools_noncentered(),
                   jamt.ASSSConfig(num_warmup=2))
    tk = amt.asss(tt, cfg)
    js = jk.init(jax.random.PRNGKey(3), n_chains=8)
    for t in range(3):
        draws = amt.ASSSDraws(*(torch.from_numpy(np.array(a))
                                for a in _jax_step_draws(js.rng_key, 10)))
        ts = interop.asss_state_from_numpy(jax.tree.map(np.asarray, js))
        got, mean_trips = tk.probe(ts, 1, draws=[draws])
        want, trips = _per_trip_step(tt, cfg, ts, draws=draws)
        assert _equal(got, want), f"step {t}"
        assert torch.equal(mean_trips, trips.to(torch.float32))
        assert _equal(tk.step(ts, draws=draws), want)
        js, jtrips = jk.probe(js, 1)
        np.testing.assert_array_equal(trips.numpy(), np.asarray(jtrips))
        jw = interop.asss_state_to_numpy(got)
        for name in ("position", "potential_energy", "as_change"):
            np.testing.assert_allclose(
                getattr(jw, name), np.asarray(getattr(js, name)),
                rtol=RTOL, atol=ATOL, err_msg=f"step {t} {name}")


@pytest.mark.parametrize("block", BLOCKS)
def test_probe_mean_trips_unchanged_on_injected_draws(monkeypatch, block):
    """probe over four steps on the 1-D mixture with injected draws of only
    the rows the per-trip loop reads: the mean trips per chain and the
    state equal the per-trip loop's; the masked trips past the last row
    read nothing and raise nothing."""
    monkeypatch.setattr(tasss, "SHRINK_TRIPS", block)
    t, cfg, C = amt.gaussian_mixture_1d(), amt.ASSSConfig(), 16
    k = amt.asss(t, cfg)
    state = k.init(torch.Generator().manual_seed(0), n_chains=C)
    rng = np.random.default_rng(1)
    draws, want, total = [], state, torch.zeros(C)
    for _ in range(4):
        full = amt.ASSSDraws(
            torch.tensor(rng.normal(size=(C, 2)), dtype=torch.float32),
            torch.tensor(rng.uniform(size=C), dtype=torch.float32),
            torch.tensor(rng.uniform(size=C), dtype=torch.float32),
            torch.tensor(rng.uniform(size=(50, C)), dtype=torch.float32))
        want_next, trips = _per_trip_step(t, cfg, want, draws=full)
        used = int(trips.max())
        draws.append(full._replace(u_shrink=full.u_shrink[:used]))
        want, total = want_next, total + trips.to(torch.float32)
    got, mean_trips = k.probe(state, 4, draws=draws)
    assert _equal(got, want)
    assert torch.equal(mean_trips, total / 4.0)
    assert float(mean_trips.mean()) > 1.0
    short = draws[0]._replace(u_shrink=draws[0].u_shrink[:0])
    if int(torch.max(total)) > 0:
        with pytest.raises(ValueError, match="u_shrink"):
            k.probe(state, 1, draws=[short])


@pytest.mark.parametrize("block", BLOCKS)
def test_generator_step_equals_per_trip_loop(monkeypatch, block):
    """From a generator of the same seed one blocked step equals the
    per-trip loop's (the masked trips draw after the last trip is read);
    the generator then stands further on by the masked trips' draws."""
    monkeypatch.setattr(tasss, "SHRINK_TRIPS", block)
    t, cfg = amt.gaussian_mixture_1d(), amt.ASSSConfig(adapt=False)
    k = amt.asss(t, cfg)
    state = k.init(torch.Generator().manual_seed(2), n_chains=64)
    before = profiling.totals().get("asss.trips", 0)
    got = k.step(state, torch.Generator().manual_seed(5))
    want, trips = _per_trip_step(t, cfg, state,
                                 torch.Generator().manual_seed(5))
    assert _equal(got, want)
    run = profiling.totals()["asss.trips"] - before
    assert run % block == 0 and int(trips.max()) <= run \
        < int(trips.max()) + block


def _frozen_mixture(loc=0.0):
    t = amt.gaussian_mixture_1d()
    return amt.analysis.frozen_asss(t, loc=loc)


@pytest.mark.parametrize("loc", [0.0, 1.0])
def test_seeded_sample_pnx_is_the_same_for_every_block_size(monkeypatch,
                                                            loc):
    """A seeded frozen-ASSS rollout (n = 5) on the mixture is the same for
    SHRINK_TRIPS = 1 and the chosen value, and equals the per-trip loop
    reseeded before every step as sample_pnx's eager loop does."""
    k, adapt = _frozen_mixture(loc)
    x = torch.tensor([[-2.0], [0.3], [1.5]])
    outs = []
    for block in (1, tasss.SHRINK_TRIPS):
        monkeypatch.setattr(tasss, "SHRINK_TRIPS", block)
        outs.append(amt.sample_pnx(k, 11, x, adapt, n=5, n_samples=200))
    assert torch.equal(outs[0], outs[1])
    cfg = dataclasses.replace(k.config, adapt=False)
    C = 600
    state = k.init(torch.Generator().manual_seed(0), n_chains=C,
                   position=x.repeat_interleave(200, 0),
                   adapt_state=ASSSAdaptState(adapt.loc.expand(C, 1),
                                              adapt.scale.expand(C, 1, 1)))
    g = torch.Generator()
    for step in range(5):
        g.manual_seed(hash((11, step)) & (2**63 - 1))
        state, _ = _per_trip_step(k.target, cfg, state, g)
    assert torch.equal(outs[0], state.position.reshape(3, 200, 1))


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """CUDA graphs stood in for on the CPU: a capture returns the block
    itself, run again at each replay; the launches it counted stay
    counted, as a replay's would be."""
    captured = []

    def capture(run_block, generator, kernel, pool=None):
        captured.append(kernel)
        return run_block

    monkeypatch.setattr(tmcmc, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return captured


@pytest.mark.parametrize("adapt", [True, False])
def test_lockstep_graph_driver_equals_the_eager_steps(stand_in_graphs,
                                                      adapt):
    """LockstepGraph over two advance calls (the second reuses the kept
    buffers and parts) against kernel.step in a loop from generators of
    the same seed: states, trips per chain and the generator's next draws
    bit for bit; the caller's state untouched; three parts captured."""
    t = amt.eight_schools_noncentered()
    k = amt.asss(t, amt.ASSSConfig(num_warmup=3, adapt=adapt))
    state = k.init(torch.Generator().manual_seed(4), n_chains=12)
    kept = [x.clone() for x in _tensors(state)]
    g_graph = torch.Generator().manual_seed(9)
    drive = tmcmc.LockstepGraph(k.step_parts, g_graph, "asss.step")
    p = drive.advance(state, 3)
    p = drive.advance(p["s"], 2)
    g = torch.Generator().manual_seed(9)
    want = state
    for _ in range(5):
        want = k.step(want, g)
    assert _equal(p["s"], want)
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=g_graph))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), kept))
    assert sorted(stand_in_graphs) == ["asss.step"] * 3


def test_lockstep_graph_reseeds_between_steps(stand_in_graphs):
    """advance with a reseed before each step (sample_pnx's seeded
    coupling) equals the eager loop reseeded alike."""
    k, adapt = _frozen_mixture(1.0)
    frozen = tmcmc._frozen(k)
    C = 300
    state = frozen.init(None, n_chains=C,
                        position=torch.linspace(-3, 3, C)[:, None],
                        adapt_state=ASSSAdaptState(
                            adapt.loc.expand(C, 1).contiguous(),
                            adapt.scale.expand(C, 1, 1).contiguous()))
    g = torch.Generator()
    drive = tmcmc.LockstepGraph(frozen.step_parts, g, "asss.step")
    got = drive.advance(state, 4, lambda t: g.manual_seed(1000 + t))["s"]
    want = state
    for t in range(4):
        g.manual_seed(1000 + t)
        want = frozen.step(want, g)
    assert _equal(got, want)
    assert torch.equal(got.adapt_state.loc, state.adapt_state.loc)
    assert int(got.i) == int(state.i)


def test_lockstep_graph_refuses_a_host_read(stand_in_graphs):
    """A potential that reads a value on the host cannot be captured: the
    driver raises with the eager advice and puts the generator back."""
    reads = amt.Target(
        name="reads", dim=1,
        potential_fn=lambda x: 0.5 * torch.sum(x * x, dim=-1)
        * float(x.abs().max() >= 0))
    k = amt.asss(reads, amt.ASSSConfig(adapt=False))
    state = k.init(torch.Generator().manual_seed(0), n_chains=4)
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    with pytest.raises(RuntimeError, match="eager=True"):
        tmcmc.LockstepGraph(k.step_parts, g, "asss.step").advance(state, 1)
    assert torch.equal(g.get_state(), before)
