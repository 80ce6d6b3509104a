"""Port parity for the driver and the slice as a whole: run_mcmc on
eight-schools with replayed JAX draws, driver shapes and thinning, the MCMC
API, the diagnostics on shared numpy draws, and a seeded posterior check
against the JAX run's Monte Carlo band.

Replayed-draw runs are compared at rtol 2e-5, atol 2e-6, normwise per
field (see test_torch_arwmh.py for why chained float32 trajectories are
compared normwise); diagnostics at rtol 1e-4 (FFT autocovariances in two
float32 FFT libraries)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu.infer import diagnostics as jdiag  # noqa: E402
from adaptive_mcmc_tpu.kernels.base import split_keys  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.infer import diagnostics as tdiag  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6


def replay_draws(keys, n_steps: int, d: int):
    """The normals and uniforms of the JAX lockstep step's key chain."""
    noise, unif = [], []
    for _ in range(n_steps):
        keys, k_prop, k_acc = split_keys(keys, 3)
        noise.append(jax.vmap(lambda k: jax.random.normal(k, (d,)))(k_prop))
        unif.append(jax.vmap(jax.random.uniform)(k_acc))
    return np.stack(noise), np.stack(unif)


def assert_close_normwise(got, want, err=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err
    assert np.isfinite(want).all() and np.isfinite(got).all(), err
    bound = ATOL + RTOL * np.max(np.abs(want))
    worst = np.max(np.abs(got - want))
    assert worst <= bound, f"{err}: max abs error {worst} > {bound}"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_run_mcmc_slice_matches_jax_on_replayed_draws(seed):
    """run_mcmc(arwmh(eight_schools_noncentered())) from the converted JAX
    init state with the JAX draws: samples and extras equal JAX's."""
    C, W, N, thin = 8, 10, 20, 2
    fields = ("potential_energy", "as_change")
    jt = jamt.eight_schools_noncentered()
    jk = jamt.arwmh(jt, jamt.ARWMHConfig(num_warmup=W))
    js = jk.init(jax.random.PRNGKey(seed), n_chains=C)
    want, want_x, want_last = jamt.run_mcmc(
        jk, None, W, N, thinning=thin, n_chains=C, extra_fields=fields,
        init_state=js)
    noise, unif = replay_draws(js.rng_key, W + N, jt.dim)

    tk = amt.arwmh(amt.eight_schools_noncentered(),
                   amt.ARWMHConfig(num_warmup=W))
    got, got_x, got_last = amt.run_mcmc(
        tk, None, W, N, thinning=thin, n_chains=C, extra_fields=fields,
        init_state=interop.arwmh_state_from_numpy(
            jax.tree.map(np.asarray, js)),
        noise=torch.from_numpy(noise), unif=torch.from_numpy(unif))
    assert got.shape == (N // thin, C, jt.dim)
    assert_close_normwise(got.numpy(), want, "samples")
    for f in fields:
        assert got_x[f].shape == (N // thin, C)
        assert_close_normwise(got_x[f].numpy(), want_x[f], f)
    assert int(got_last.i) == int(want_last.i) == W + N
    assert_close_normwise(got_last.adapt_state.scale.numpy(),
                          want_last.adapt_state.scale, "scale")


@pytest.mark.parametrize("fused", [False, True])
def test_run_mcmc_shapes_and_thinning(fused):
    t = amt.eight_schools_noncentered()
    k = amt.arwmh(t, amt.ARWMHConfig(fused=fused))
    fields = ("potential_energy", "as_change")
    samples, extras, last = amt.run_mcmc(
        k, _gen(0), num_warmup=10, num_samples=40, thinning=4, n_chains=5,
        extra_fields=fields)
    assert samples.shape == (10, 5, t.dim)
    for f in fields:
        assert extras[f].shape == (10, 5)
    assert int(last.i) == 50
    # the recorded potential is that of the recorded position
    np.testing.assert_allclose(
        extras["potential_energy"][-1].numpy(),
        t.potential_fn(samples[-1]).numpy(), rtol=1e-6)
    # thinning=3 collects every third state of the thinning=1 stream
    s1, _, _ = amt.run_mcmc(k, _gen(1), num_warmup=0, num_samples=12,
                            n_chains=2)
    s3, _, _ = amt.run_mcmc(k, _gen(1), num_warmup=0, num_samples=12,
                            thinning=3, n_chains=2)
    np.testing.assert_array_equal(s1[2::3].numpy(), s3.numpy())
    with pytest.raises(ValueError):
        amt.run_mcmc(k, _gen(1), num_warmup=0, num_samples=10, thinning=3)


def test_determinism_same_generator_seed():
    k = amt.arwmh(amt.eight_schools_noncentered())
    a, _, _ = amt.run_mcmc(k, _gen(7), 20, 50, n_chains=3)
    b, _, _ = amt.run_mcmc(k, _gen(7), 20, 50, n_chains=3)
    c, _, _ = amt.run_mcmc(k, _gen(8), 20, 50, n_chains=3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.allclose(a.numpy(), c.numpy())


def test_mcmc_class_api(capsys):
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.arwmh(t), num_warmup=200, num_samples=400,
                    thinning=2, n_chains=4)
    mcmc.run(_gen(2), extra_fields=("potential_energy",))
    sites = mcmc.get_samples()
    assert set(sites) == {"mu", "tau", "theta_base"}
    assert sites["mu"].shape == (800,)
    assert sites["theta_base"].shape == (800, 8)
    assert bool(torch.all(sites["tau"] > 0))
    assert mcmc.get_samples(group_by_chain=True)["mu"].shape == (200, 4)
    assert mcmc.get_extra_fields()["potential_energy"].shape == (200, 4)
    # the warmup clock was propagated into the kernel config
    assert mcmc.kernel.config.num_warmup == 200
    assert "Acceptance rate" in mcmc.diagnostics_str()
    mcmc.print_summary()
    out = capsys.readouterr().out
    assert "theta_base[7]" in out and "r_hat" in out
    adapt = amt.get_init_adapt_state(amt.arwmh(t), _gen(3),
                                     position=torch.zeros(t.dim))
    np.testing.assert_array_equal(adapt.scale[0].numpy(), np.eye(t.dim))


def _ar1(n, m, p, phi=0.7, seed=0):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(n, m, p))
    x = np.zeros_like(eps)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi ** 2) * eps[t]
    return (x + rng.normal(size=(1, m, p)) * 0.1).astype(np.float32)


def test_diagnostics_match_jax():
    x = _ar1(501, 6, 3)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tdiag.gelman_rubin(tx).numpy(),
                               np.asarray(jdiag.gelman_rubin(x)), rtol=1e-4)
    np.testing.assert_allclose(
        tdiag.gelman_rubin(tx, split=False).numpy(),
        np.asarray(jdiag.gelman_rubin(x, split=False)), rtol=1e-4)
    np.testing.assert_allclose(
        tdiag.effective_sample_size(tx).numpy(),
        np.asarray(jdiag.effective_sample_size(x)), rtol=1e-4)
    np.testing.assert_array_equal(tdiag.split_chains(tx).numpy(),
                                  np.asarray(jdiag.split_chains(x)))
    got, want = tdiag.summarize(tx), jdiag.summarize(jnp.asarray(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _mu_band(samples, ess):
    mu = np.asarray(samples)[..., 0]
    return float(mu.mean()), float(mu.std() / np.sqrt(ess))


@pytest.mark.parametrize("fused", [False, True])
def test_eight_schools_mu_within_jax_monte_carlo_band(fused):
    """The port's posterior mean of mu (lockstep, and the fused drive's
    plain version) lies within 4 combined Monte Carlo standard errors of
    the JAX run's, each error from its own ESS."""
    C, W, N = 64, 500, 1500
    jk = jamt.arwmh(jamt.eight_schools_noncentered(),
                    jamt.ARWMHConfig(num_warmup=W))
    js, _, _ = jamt.run_mcmc(jk, jax.random.PRNGKey(11), W, N, n_chains=C)
    j_mean, j_se = _mu_band(
        js, float(jdiag.effective_sample_size(js[..., :1])[0]))
    tk = amt.arwmh(amt.eight_schools_noncentered(),
                   amt.ARWMHConfig(num_warmup=W, fused=fused))
    ts, _, last = amt.run_mcmc(tk, _gen(11), W, N, n_chains=C)
    t_mean, t_se = _mu_band(
        ts, float(tdiag.effective_sample_size(ts[..., :1])[0]))
    assert abs(t_mean - j_mean) < 4.0 * np.hypot(t_se, j_se), (
        t_mean, t_se, j_mean, j_se)
    assert 0.15 < float(last.mean_accept_prob.mean()) < 0.35


# ---- the blocks of steps that a CUDA device runs from a graph ------------

from adaptive_mcmc_tpu_torch.infer import mcmc as tmcmc  # noqa: E402


def _kernel(name):
    t = amt.eight_schools_noncentered()
    if name == "arwmh":
        return amt.arwmh(t, amt.ARWMHConfig(num_warmup=13))
    return amt.rwm(t, step_size=0.3)


@pytest.fixture
def blocks_on_cpu(monkeypatch):
    """run_mcmc takes its blocks of steps (StepBlocks, static buffers) on
    the CPU, the graph replaced by a plain call of the block function; the
    fixture's list collects the length of every block that was 'captured'."""
    captured = []

    def plain(run_block, generator, kernel):
        captured.append(kernel.name)
        return run_block

    monkeypatch.setattr(tmcmc, "_on_card", lambda state: True)
    monkeypatch.setattr(tmcmc, "_capture", plain)
    return captured


@pytest.mark.parametrize("thinning", [1, 5])
@pytest.mark.parametrize("name", ["arwmh", "rwm"])
def test_step_blocks_give_the_eager_draws(blocks_on_cpu, name, thinning):
    """Warmup 13 is no multiple of the block of 5: the first step, which
    always runs eagerly, two blocks and two single steps.  Samples, extras
    and the last state equal the eager loop's bit for bit, and the caller's
    init_state is left as it was."""
    k = _kernel(name)
    C, W, N = 4, 13, 20
    fields = ("potential_energy", "as_change")
    init = k.init(_gen(5), n_chains=C)
    kept = [t.clone() for t in tmcmc.state_tensors(init)]
    want, want_x, want_last = amt.run_mcmc(
        k, _gen(6), W, N, thinning=thinning, n_chains=C, init_state=init,
        extra_fields=fields, eager=True)
    assert not blocks_on_cpu
    got, got_x, got_last = amt.run_mcmc(
        k, _gen(6), W, N, thinning=thinning, n_chains=C, init_state=init,
        extra_fields=fields)
    assert blocks_on_cpu == [name]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for f in fields:
        np.testing.assert_array_equal(got_x[f].numpy(), want_x[f].numpy())
    for a, b in zip(tmcmc.state_tensors(got_last),
                    tmcmc.state_tensors(want_last)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(got_last.i) == W + N
    for a, b in zip(tmcmc.state_tensors(init), kept):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the frames are copies: none aliases a buffer of the last state
    ptrs = {t.data_ptr() for t in tmcmc.state_tensors(got_last)}
    assert got[-1].data_ptr() not in ptrs
    # successive frames differ (a replay that repeated one draw would not)
    if name == "arwmh":
        assert not np.array_equal(got[0].numpy(), got[-1].numpy())


def test_step_blocks_are_not_taken_on_the_cpu():
    """Without the fixture a CPU run is the eager loop; ASSS's step is not
    declared capturable, ARWMH's and RWM's are."""
    t = amt.eight_schools_noncentered()
    assert amt.arwmh(t).graph_step and amt.rwm(t).graph_step
    assert not amt.asss(t).graph_step
    k = amt.arwmh(t)
    a, _, _ = amt.run_mcmc(k, _gen(7), 5, 10, n_chains=2)
    b, _, _ = amt.run_mcmc(k, _gen(7), 5, 10, n_chains=2, eager=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("block,counts", [
    (1, (3,)), (10, (10, 10)), (64, (100,)), (64, (5, 64, 7)),
    (4, (1, 1, 1)), (7, (0, 13))])
def test_step_blocks_advance_any_count(blocks_on_cpu, block, counts):
    """advance(n) for any n and block: the first step eagerly, whole blocks
    from the one capture, the rest eagerly; the state equals that of as many
    eager steps bit for bit."""
    k = _kernel("arwmh")
    init = k.init(_gen(3), n_chains=3)
    g = _gen(4)
    want = init
    for _ in range(sum(counts)):
        want = k.step(want, g)
    blocks = tmcmc.StepBlocks(k, _gen(4), init, block)
    for n in counts:
        got = blocks.advance(n)
    assert blocks_on_cpu == ["arwmh"]
    assert int(got.i) == sum(counts)
    for a, b in zip(tmcmc.state_tensors(got), tmcmc.state_tensors(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _host_reading_target(how):
    base = amt.eight_schools_noncentered()

    def potential(x):
        pe = base.potential_fn(x)
        if how == "item":
            return pe + 0.0 * pe.max().item()
        if how == "bool":
            return pe if bool((pe > -1e30).all()) else pe * 2
        return pe + 0.0 * x[x[:, 0] > -1e30].sum()      # masked: data shape
    import dataclasses
    return dataclasses.replace(base, potential_fn=potential,
                               device_potential=None)


@pytest.mark.parametrize("how", ["item", "bool", "mask"])
def test_a_potential_that_reads_the_host_is_refused(blocks_on_cpu, how):
    """Capture is refused with a message that names the step and the eager
    loop; nothing falls back quietly, the generator is left where it was,
    and eager=True runs."""
    k = amt.arwmh(_host_reading_target(how))
    g = _gen(9)
    before = g.get_state().clone()
    with pytest.raises(RuntimeError, match=r"arwmh\.step.*eager=True"):
        amt.run_mcmc(k, g, 4, 8, n_chains=3, init_position=torch.zeros(10))
    assert torch.equal(g.get_state(), before)
    assert not blocks_on_cpu
    with pytest.raises(RuntimeError, match="eager=True"):
        amt.MCMC(k, num_warmup=4, num_samples=8, n_chains=3).run(_gen(9))
    samples, _, _ = amt.run_mcmc(k, _gen(9), 4, 8, n_chains=3, eager=True)
    assert samples.shape == (8, 3, 10)
    # the check alone, on a state of the caller's: a step it lets through
    # is the plain step
    state = k.init(_gen(1), n_chains=2)
    with pytest.raises(RuntimeError, match="cannot capture"):
        tmcmc.checked_step(k, state, _gen(1))
    plain = amt.arwmh(amt.eight_schools_noncentered())
    got = tmcmc.checked_step(plain, state, _gen(1))
    want = plain.step(state, _gen(1))
    for a, b in zip(tmcmc.state_tensors(got), tmcmc.state_tensors(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_a_captured_launch_counts_once_per_replay(monkeypatch):
    """What a capture adds to a kernel's launch count is taken off again
    and added once per replay (on the CPU with a stand-in for the graph);
    a launch outside a capture stays counted."""
    from adaptive_mcmc_tpu_torch.ops import cuda as ops_cuda
    from adaptive_mcmc_tpu_torch.ops.cuda import chol_update as k1

    class FakeGraph:
        def register_generator_state(self, g):
            self.generator = g

        def replay(self):
            self.replays = getattr(self, "replays", 0) + 1

    class fake_capture:
        def __init__(self, graph):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(k1, "launches", 7)

    def block():
        k1.launches += 3            # three launches recorded at capture

    g = _gen(0)
    replay = tmcmc._capture(block, g, _kernel("arwmh"))
    assert k1.launches == 7
    replay()
    replay()
    assert k1.launches == 13
    assert ops_cuda.launch_counts()["chol_update"] == 13


# -- where the draws land: MCMC.run on the host, run_mcmc where made -------

def _landing_kernel(name):
    """ARWMH through the lockstep loop, or fused ASSS through ``collect_n``
    (K3's plain version on the CPU), both built at the runs' warmup."""
    t = amt.eight_schools_noncentered()
    if name == "arwmh":
        return amt.arwmh(t, amt.ARWMHConfig(num_warmup=20))
    return amt.asss(t, amt.ASSSConfig(num_warmup=20, fused=True))


@pytest.fixture
def landings(monkeypatch):
    """The calls of ``run_mcmc``'s landing of frames on the host, each
    recorded by the fields it was given, the landing itself left as it
    is."""
    calls = []
    land = tmcmc._to_host

    def recorded(bufs, fields):
        calls.append(tuple(fields))
        return land(bufs, fields)

    monkeypatch.setattr(tmcmc, "_to_host", recorded)
    return calls


@pytest.mark.parametrize("caller", ["run_mcmc", "checkpointed"])
@pytest.mark.parametrize("name", ["arwmh", "asss"])
def test_run_mcmc_keeps_its_frames_where_they_were_made(landings, tmp_path,
                                                        name, caller):
    """run_mcmc's default, and the checkpointed driver on it, leave the
    frames where the run made them and never ask for the landing."""
    k = _landing_kernel(name)
    fields = ("potential_energy",)
    if caller == "run_mcmc":
        samples, extras, _ = amt.run_mcmc(k, _gen(5), 20, 40, thinning=4,
                                          n_chains=3, extra_fields=fields)
        for t in (samples, extras["potential_energy"]):
            assert t.device.type == "cpu" and not t.is_pinned()
    else:
        from adaptive_mcmc_tpu_torch.infer import run_mcmc_checkpointed
        samples, _, _ = run_mcmc_checkpointed(
            k, _gen(5), 20, 40, thinning=4, n_chains=3, extra_fields=fields,
            checkpoint_dir=tmp_path, chunk_size=20)
        assert samples.shape == (10, 3, 10)
    assert landings == []


@pytest.mark.parametrize("name", ["arwmh", "asss"])
def test_mcmc_run_equals_run_mcmc_bit_for_bit(landings, name):
    """MCMC.run asks for the landing of exactly the requested fields, and
    on the CPU hands back run_mcmc's draws and extras at the same seed, bit
    for bit, in the same views."""
    k = _landing_kernel(name)
    fields = ("potential_energy",)
    want, want_extras, want_last = amt.run_mcmc(
        k, _gen(6), 20, 40, thinning=4, n_chains=3, extra_fields=fields)
    assert landings == []
    mcmc = amt.MCMC(k, num_warmup=20, num_samples=40, thinning=4,
                    n_chains=3)
    mcmc.run(_gen(6), extra_fields=fields)
    assert landings == [("position", "potential_energy")]
    got = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    got_pe = mcmc.get_extra_fields()["potential_energy"]
    for a, b in ((got, want), (got_pe, want_extras["potential_energy"])):
        assert a.shape == b.shape and a.stride() == b.stride()
        assert torch.equal(a, b)
    for a, b in zip(tmcmc.state_tensors(mcmc.last_state),
                    tmcmc.state_tensors(want_last)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["arwmh", "asss"])
def test_mcmc_run_lands_no_bytes_on_the_cpu(name):
    """A CPU run's frames are on the host already: no bytes are copied
    and run_mcmc.host_bytes stays 0."""
    from adaptive_mcmc_tpu_torch.utils import profiling

    profiling.clear()
    mcmc = amt.MCMC(_landing_kernel(name), num_warmup=20, num_samples=40,
                    thinning=4, n_chains=3)
    mcmc.run(_gen(7), extra_fields=("potential_energy",))
    assert profiling.totals().get("run_mcmc.host_bytes", 0) == 0
    assert not mcmc.get_samples(flat_unconstrained=True).is_pinned()
