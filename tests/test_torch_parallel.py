"""The parallel layer of the port (adaptive_mcmc_tpu_torch.parallel) in one
process: fan_state's clone-major layout against JAX's on the same state,
run_mcmc_sharded against the port's run_mcmc bit for bit and call for call
(every outcome of infer.mcmc.collector: the lockstep loop, collect_n,
step_n's frame loop, K2's and K3's plain versions), chunked runs against
unchunked ones, fan-out shapes, the one-process chain mesh, and the
collectives against JAX's on its 8-device CPU test mesh (rtol 1e-5) and
against plain torch and the split R̂ of infer.diagnostics.  The mesh over several processes:
tests/test_torch_distributed.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu import ARWMHConfig as JConfig  # noqa: E402
from adaptive_mcmc_tpu import arwmh as jarwmh  # noqa: E402
from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu import parallel as jpar  # noqa: E402
from adaptive_mcmc_tpu.parallel.run import fan_state as jfan  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.infer.mcmc import (  # noqa: E402
    collector,
    state_tensors,
)
from adaptive_mcmc_tpu_torch.infer.diagnostics import (  # noqa: E402
    gelman_rubin,
)
from adaptive_mcmc_tpu_torch.parallel import (  # noqa: E402
    ChainMesh,
    chain_mesh,
    chain_sharding,
    cross_chain_moments,
    fan_state,
    initialize_distributed,
    replicated,
    run_mcmc_sharded,
    sharded_gelman_rubin,
)

CPU = torch.device("cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_fan_state_layout_matches_jax():
    """The same positions and adapt state through both fan_states: every
    per-chain leaf tiles clone-major, the iteration counter stays."""
    C, F, d = 5, 4, 3
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(C, d)).astype(np.float32)
    jk = jarwmh(jm.std_normal(d), JConfig(num_warmup=0))
    js = jk.init(jax.random.PRNGKey(0), n_chains=C,
                 position=jnp.asarray(pos))
    ts = amt.arwmh(amt.std_normal(d)).init(n_chains=C,
                                           position=torch.from_numpy(pos))
    # the two packages' potentials round apart: feed JAX the port's
    js = js._replace(potential_energy=jnp.asarray(
        ts.potential_energy.numpy()))
    jf, tf = jfan(js, F), fan_state(ts, F)
    for name in ("position", "potential_energy", "mean_accept_prob",
                 "as_change"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)))
    for a, b in zip(tf.adapt_state, jf.adapt_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tf.position.shape == (C * F, d) and int(tf.i) == int(jf.i)
    np.testing.assert_array_equal(
        tf.position.numpy().reshape(C, F, d),
        np.repeat(pos[:, None], F, axis=1))


def _spied(kernel, calls: list):
    """``kernel`` with its ``step``, ``step_n`` and ``collect_n`` each
    appending its name to ``calls`` when called."""
    def spy(name, fn):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

    return dataclasses.replace(kernel, **{
        n: spy(n, getattr(kernel, n))
        for n in ("step", "step_n", "collect_n")
        if getattr(kernel, n) is not None})


# every outcome of infer.mcmc.collector: (kernel, extra fields, collector)
SHARDED_CASES = {
    "arwmh": (lambda t: amt.arwmh(t, amt.ARWMHConfig(num_warmup=6)),
              ("potential_energy", "as_change"), "lockstep"),
    "asss": (lambda t: amt.asss(t, amt.ASSSConfig(num_warmup=6)),
             ("potential_energy", "as_change"), "collect_n"),
    "nuts": (lambda t: amt.nuts(t, amt.NUTSConfig(num_warmup=6)),
             ("potential_energy",), "collect_n"),
    "nuts_diverging": (lambda t: amt.nuts(t, amt.NUTSConfig(num_warmup=6)),
                       ("diverging",), "step_n"),
    "arwmh_k2": (lambda t: amt.arwmh(t, amt.ARWMHConfig(num_warmup=6,
                                                        fused=True)),
                 ("potential_energy", "as_change"), "collect_n"),
    "asss_k3": (lambda t: amt.asss(t, amt.ASSSConfig(num_warmup=6,
                                                     fused=True)),
                ("potential_energy", "as_change"), "collect_n"),
}


@pytest.mark.parametrize("name", list(SHARDED_CASES))
def test_sharded_equals_run_mcmc(name):
    """run_mcmc_sharded on one process equals run_mcmc bit for bit, through
    the same driver calls in the same order, for every way a run's frames
    are collected (the fused kernels through K2's and K3's plain
    versions)."""
    build, fields, how = SHARDED_CASES[name]
    k = build(amt.eight_schools_noncentered())
    assert collector(k, ("position", *fields)) == how
    want_calls, got_calls = [], []
    want = amt.run_mcmc(_spied(k, want_calls), _gen(3), 6, 12, thinning=3,
                        n_chains=8, extra_fields=fields)
    got = run_mcmc_sharded(_spied(k, got_calls), _gen(3), 6, 12, thinning=3,
                           n_chains=8, extra_fields=fields)
    assert got_calls == want_calls
    assert ("collect_n" in got_calls) == (how == "collect_n")
    assert set(got_calls) <= ({"step"} if how == "lockstep"
                              else {"step_n", "collect_n"})
    assert got[0].shape == (4, 8, 10)
    assert torch.equal(got[0], want[0])
    for f in fields:
        assert torch.equal(got[1][f], want[1][f])
    for a, b in zip(state_tensors(got[2]), state_tensors(want[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["arwmh", "sa"])
def test_chunked_equals_unchunked(name):
    """A lockstep kernel's chunk boundary changes no draw, in the warmup
    (chunks of 7 steps) and in the collection (chunks of 2 frames)."""
    t = amt.eight_schools_noncentered()
    k = amt.arwmh(t, amt.ARWMHConfig(num_warmup=10)) if name == "arwmh" \
        else amt.sa(t, amt.SAConfig(num_warmup=10))
    whole = run_mcmc_sharded(k, _gen(4), 10, 24, thinning=3, n_chains=6,
                             extra_fields=("potential_energy",))
    chunked = run_mcmc_sharded(k, _gen(4), 10, 24, thinning=3, n_chains=6,
                               extra_fields=("potential_energy",),
                               max_steps_per_call=7)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1]["potential_energy"],
                       chunked[1]["potential_energy"])
    for a, b in zip(state_tensors(whole[2]), state_tensors(chunked[2])):
        assert torch.equal(a, b)


def test_chunked_asss_collects_every_frame():
    """The machine's chunks (here 2 frames per collect_n call) end at a
    barrier and draw differently, but every frame is a landed state."""
    k = amt.asss(amt.eight_schools_noncentered(),
                 amt.ASSSConfig(num_warmup=4))
    s, extras, last = run_mcmc_sharded(
        k, _gen(5), 4, 18, thinning=3, n_chains=6,
        extra_fields=("potential_energy",), max_steps_per_call=6)
    assert s.shape == (6, 6, 10) and int(last.i) == 22
    assert torch.isfinite(s).all() and not (s == 0).all(dim=-1).any()
    torch.testing.assert_close(extras["potential_energy"],
                               k.target.potential_fn(s.reshape(-1, 10))
                               .reshape(6, 6))
    assert torch.equal(s[-1], last.position)


@pytest.mark.parametrize("name", ["arwmh", "nuts"])
def test_fan_out_shapes_and_distinct_clones(name):
    """fan_out=4: (frames, C*F, d) with clones contiguous per chain; the
    clones start equal and part after sampling."""
    t = amt.std_normal(3)
    k = amt.arwmh(t, amt.ARWMHConfig(num_warmup=0)) if name == "arwmh" \
        else amt.nuts(t, amt.NUTSConfig(num_warmup=8))
    samples, extras, last = run_mcmc_sharded(
        k, _gen(1), 8, 64, thinning=2, n_chains=8, fan_out=4,
        extra_fields=("potential_energy",))
    assert samples.shape == (8, 32, 3)        # 64 / (2 * 4) frames
    assert extras["potential_energy"].shape == (8, 32)
    assert last.position.shape == (32, 3)
    assert len({tuple(r) for r in samples[-1].tolist()}) == 32
    with pytest.raises(ValueError, match="thinning \\* fan_out"):
        run_mcmc_sharded(k, _gen(1), 8, 60, thinning=2, n_chains=8,
                         fan_out=4)


def test_one_process_chain_mesh():
    """With no process group: a one-device mesh of this process, its
    sharding the whole chain axis; a mesh of several devices raises and
    says how to launch (one process per device); no silent CPU."""
    mesh = chain_mesh(devices=["cpu"])
    assert mesh == ChainMesh(CPU) and chain_mesh(1, devices=["cpu"]) == mesh
    assert (mesh.size, mesh.rank, mesh.member, mesh.group) == (1, 0, True,
                                                               None)
    assert chain_sharding(mesh, 6) == slice(0, 6)
    assert replicated(mesh) == CPU
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        chain_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="one device"):
        chain_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="RANK"):
        initialize_distributed(num_processes=2)
    assert initialize_distributed() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chain_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            initialize_distributed(num_processes=2, process_id=0)


def test_cli_mesh_devices_without_a_process_group_says_how_to_launch(
        tmp_path):
    from adaptive_mcmc_tpu_torch.experiments import cli

    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        cli.main(["w_eval", "--target", "eight_schools", "--kernel",
                  "arwmh", "--seeds", "4", "--scale", "0.0002",
                  "--out-dir", str(tmp_path), "--device", "cpu",
                  "--mesh-devices", "2"])
    assert not (tmp_path / "w_eval").exists()


def test_generator_and_mesh_must_agree():
    k = amt.arwmh(amt.std_normal(2))
    with pytest.raises(ValueError, match="generator"):
        run_mcmc_sharded(k, _gen(0), 2, 4, n_chains=2,
                         mesh=ChainMesh(torch.device("meta")))


@pytest.mark.parametrize("shape", [(64, 3), (32, 2, 5)])
def test_cross_chain_moments_match_jax_and_plain_torch(shape):
    x = np.random.default_rng(3).normal(0.5, 1.5, size=shape) \
        .astype(np.float32)
    mean, var = cross_chain_moments(torch.from_numpy(x),
                                    chain_mesh(devices=["cpu"]))
    jmean, jvar = jpar.cross_chain_moments(jnp.asarray(x), jpar.chain_mesh())
    assert len(jax.devices()) == 8 and mean.shape == shape[1:]
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5)
    t = torch.from_numpy(x)
    torch.testing.assert_close(mean, t.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, t.var(0, correction=0), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("draws", [200, 201])
def test_sharded_gelman_rubin_matches_jax_and_split_rhat(draws):
    """(draws, chains, d), chains split over JAX's 8 devices; an odd draw
    count drops the middle draw in both."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(draws, 16, 3))
         + rng.normal(0, 0.3, size=(1, 16, 3))).astype(np.float32)
    got = sharded_gelman_rubin(torch.from_numpy(x))
    want = jpar.sharded_gelman_rubin(jnp.asarray(x), jpar.chain_mesh())
    assert got.shape == (3,) and float(got.min()) > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    torch.testing.assert_close(got, gelman_rubin(torch.from_numpy(x)),
                               rtol=1e-5, atol=0)
