"""Port parity for the checkpointed driver and the checkpoint utilities
(tests/test_checkpointed.py): a checkpointed run equals the uninterrupted
run_mcmc bit for bit, and so does a run resumed after an interruption (the
generator's state is restored from the checkpoint); the health check fires
where JAX's does on the same numpy state; save_state/load_state round-trip
every kind of state; SweepManifest behaves as JAX's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu.infer import (  # noqa: E402
    ChainHealthError as JChainHealthError,
    check_chain_health as j_check_chain_health,
)
from adaptive_mcmc_tpu.utils import (  # noqa: E402
    SweepManifest as JSweepManifest,
)
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.infer import (  # noqa: E402
    ChainHealthError,
    check_chain_health,
    run_mcmc_checkpointed,
)
from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors  # noqa: E402
from adaptive_mcmc_tpu_torch.utils import (  # noqa: E402
    SweepManifest,
    load_state,
    save_state,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", ["arwmh", "sa"])
def test_matches_uninterrupted_run(tmp_path, name):
    t = amt.std_normal(3)
    k = amt.arwmh(t) if name == "arwmh" else \
        amt.sa(t, amt.SAConfig(adapt_state_size=8))
    want, want_x, want_state = amt.run_mcmc(
        k, _gen(0), 5, 40, thinning=2, n_chains=4,
        extra_fields=("potential_energy",))
    got, got_x, got_state = run_mcmc_checkpointed(
        k, _gen(0), 5, 40, thinning=2, n_chains=4,
        extra_fields=("potential_energy",), checkpoint_dir=tmp_path / "a",
        chunk_size=16)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got_x["potential_energy"],
                                  want_x["potential_energy"].numpy())
    for a, b in zip(state_tensors(got_state), state_tensors(want_state)):
        assert torch.equal(a, b)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "chunk_00000.npz", "chunk_00001.npz", "chunk_00002.npz",
        "generator.npy", "progress.json", "state.npz"]


def test_resume_after_interruption(tmp_path):
    """The first chunk only, then the whole run with a generator seeded
    otherwise: the resume restores the checkpoint's generator state and
    draws what the uninterrupted run draws."""
    k = amt.arwmh(amt.std_normal(2))
    d = tmp_path / "b"
    run_mcmc_checkpointed(k, _gen(1), 3, 16, n_chains=2, checkpoint_dir=d,
                          chunk_size=16)
    g = _gen(12345)
    got, _, got_state = run_mcmc_checkpointed(
        k, g, 3, 48, n_chains=2, checkpoint_dir=d, chunk_size=16)
    assert got.shape == (48, 2, 2)
    want_g = _gen(1)
    want, _, want_state = amt.run_mcmc(k, want_g, num_warmup=3,
                                       num_samples=48, n_chains=2)
    np.testing.assert_array_equal(got, want.numpy())
    for a, b in zip(state_tensors(got_state), state_tensors(want_state)):
        assert torch.equal(a, b)
    # the caller's generator stands where the uninterrupted run's does
    assert torch.equal(g.get_state(), want_g.get_state())


def test_health_check_fires_as_jax():
    jst = jax.tree.map(np.asarray, jamt.arwmh(jamt.std_normal(2)).init(
        jax.random.PRNGKey(2), n_chains=4))
    st = interop.arwmh_state_from_numpy(jst)
    check_chain_health(st)
    j_check_chain_health(jst)
    pe = st.potential_energy.clone()
    pe[0] = float("inf")
    pos = st.position.clone()
    pos[0, 0] = float("nan")
    for bad in (st._replace(potential_energy=pe), st._replace(position=pos)):
        with pytest.raises(ChainHealthError):
            check_chain_health(bad)
        with pytest.raises(JChainHealthError):
            j_check_chain_health(interop.arwmh_state_to_numpy(bad))
    # one bad chain in four is within max_bad_frac=0.25
    check_chain_health(st._replace(potential_energy=pe), max_bad_frac=0.25)


@pytest.mark.parametrize("name", ["arwmh", "asss", "sa"])
def test_save_load_round_trip(tmp_path, name):
    t = amt.eight_schools_noncentered()
    k = {"arwmh": amt.arwmh, "asss": amt.asss,
         "sa": lambda t: amt.sa(t, amt.SAConfig(adapt_state_size=20))}[name](t)
    g = _gen(5)
    st = k.step(k.init(g, n_chains=3), g)
    save_state(tmp_path / "s.npz", st)
    like = k.init(_gen(6), n_chains=3)
    back = load_state(tmp_path / "s.npz", like)
    assert type(back) is type(st)
    for a, b in zip(state_tensors(back), state_tensors(st)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    other = amt.arwmh(t) if name != "arwmh" else amt.asss(t)
    with pytest.raises(ValueError, match="holds"):
        load_state(tmp_path / "s.npz", other.init(_gen(7), n_chains=3))


def test_sweep_manifest_as_jax(tmp_path):
    for cls, path in ((SweepManifest, tmp_path / "t" / "m.json"),
                      (JSweepManifest, tmp_path / "j" / "m.json")):
        m = cls(path)
        assert not m.is_done("a")
        m.mark_done("b")
        m.mark_done("a")
        again = cls(path)
        assert again.is_done("a") and again.is_done("b")
        assert not again.is_done("c")
    assert (tmp_path / "t" / "m.json").read_text() == \
        (tmp_path / "j" / "m.json").read_text()
