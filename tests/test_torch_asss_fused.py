"""Kernel K3's plain version (ops/cuda/asss_fused.py) against the Pallas
fused ASSS kernel, run in interpret mode as tests/test_pallas.py runs it,
and on its own.

Both sides take the same state and the same injected draws (unif3, n01)
and consume draw row k in iteration k, so they land, shrink and adapt
alike.  Tolerance rtol 2e-4, atol 2e-5, that of test_pallas.py's fused
ASSS parity.  Over 25 chained transitions the float32 rounding of the two
packages (XLA contracts multiply-adds) compounds, and an entry near zero
then carries the error of its field's scale, so the runs are compared
normwise per field: max|got - want| <= atol + rtol * max|want|."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu.kernels.asss import ASSSConfig as JConfig  # noqa: E402
from adaptive_mcmc_tpu.ops.pallas.asss_fused import (  # noqa: E402
    build_fused_asss as jbuild_fused,
)
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
NAMES = ("x", "pe", "loc", "scale", "i", "as_change")


def assert_close_normwise(got, want, err=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err
    assert np.isfinite(got).all() and np.isfinite(want).all(), err
    bound = ATOL + RTOL * np.max(np.abs(want))
    worst = np.max(np.abs(got - want))
    assert worst <= bound, f"{err}: max abs error {worst} > {bound}"


def _inputs(C=8, rows=600, seed=0):
    """Eight-schools state and iid draws made with numpy
    (test_pallas.py:369-380)."""
    jt = jm.eight_schools_noncentered()
    d = jt.dim
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(C, d)) * 0.5).astype(np.float32)
    pe = np.asarray(jax.vmap(jt.potential_fn)(jnp.asarray(x)))
    state = (x, pe, np.zeros((C, d), np.float32),
             np.broadcast_to(np.eye(d, dtype=np.float32), (C, d, d)).copy(),
             0, np.zeros(C, np.float32))
    unif3 = rng.uniform(1e-6, 1 - 1e-6, size=(rows, 3, C)) \
        .astype(np.float32)
    n01 = rng.normal(size=(rows, d + 1, C)).astype(np.float32)
    return jt, state, unif3, n01


def _torch_state(state):
    return tuple(torch.tensor(a) if isinstance(a, np.ndarray) else a
                 for a in state)


def _jax_state(state):
    return tuple(jnp.asarray(a) for a in state)


def test_plain_version_matches_pallas_kernel():
    """25 steps, no frames (one chunk): state for state."""
    jt, state, unif3, n01 = _inputs()
    want, _ = jbuild_fused(jt, JConfig(num_warmup=10))(
        _jax_state(state), 25, unif3=jnp.asarray(unif3),
        n01=jnp.asarray(n01), interpret=True)
    drive = k3.build_fused_asss(amt.eight_schools_noncentered(),
                                amt.ASSSConfig(num_warmup=10))
    got, frames, iters = drive(_torch_state(state), 25,
                               unif3=torch.from_numpy(unif3),
                               n01=torch.from_numpy(n01), return_iters=True)
    assert frames == {}
    assert int(iters.max()) <= unif3.shape[0], "draw rows exhausted"
    assert int(iters.min()) >= 26
    assert int(got[4]) == 25
    for g, w, name in zip(got, want, NAMES):
        assert_close_normwise(g.numpy(), w, name)


def test_plain_version_collect_matches_pallas_kernel():
    """One single-chunk collect (F = 4, thinning 3): state and frames; the
    last frame is the final state."""
    jt, state, unif3, n01 = _inputs(seed=3)
    F, thin = 4, 3
    want_state, want = jbuild_fused(jt, JConfig(num_warmup=6))(
        _jax_state(state), F * thin, n_frames=F, thinning=thin,
        unif3=jnp.asarray(unif3), n01=jnp.asarray(n01), interpret=True)
    drive = k3.build_fused_asss(amt.eight_schools_noncentered(),
                                amt.ASSSConfig(num_warmup=6))
    got_state, got = drive(_torch_state(state), F * thin, F, thin,
                           unif3=torch.from_numpy(unif3),
                           n01=torch.from_numpy(n01))
    for g, w, name in zip(got_state, want_state, NAMES):
        assert_close_normwise(g.numpy(), w, name)
    assert got["position"].shape == (8, F, 10)
    for k in ("position", "potential_energy", "as_change"):
        assert got[k].shape[:2] == (8, F)
        assert_close_normwise(got[k].numpy(), want[k], k)
    np.testing.assert_array_equal(got["position"][:, -1].numpy(),
                                  got_state[0].numpy())
    np.testing.assert_array_equal(got["potential_energy"][:, -1].numpy(),
                                  got_state[1].numpy())
    np.testing.assert_array_equal(got["as_change"][:, -1].numpy(),
                                  got_state[5].numpy())


def test_plain_version_posterior_moments_std_normal():
    """test_pallas.py:436-466: the plain version on std_normal(3) with
    injected iid draws, 200 transitions of burn-in, then 600 thinned
    frames; pooled mean s.e. about 0.01, so 0.1 is about 10 sigma."""
    t = amt.std_normal(3)
    d, C, rows = t.dim, 16, 4000
    rng = np.random.default_rng(11)
    x0 = torch.from_numpy((rng.normal(size=(C, d)) * 2.0).astype(np.float32))
    state = (x0, t.potential_fn(x0), torch.zeros(C, d),
             torch.eye(d).expand(C, d, d).contiguous(), 0, torch.zeros(C))
    unif3 = torch.from_numpy(
        rng.uniform(1e-7, 1 - 1e-7, size=(rows, 3, C)).astype(np.float32))
    n01 = torch.from_numpy(
        rng.normal(size=(rows, d + 1, C)).astype(np.float32))
    drive = k3.build_fused_asss(t, amt.ASSSConfig(num_warmup=200))
    st1, _ = drive(state, 200, unif3=unif3, n01=n01)
    _, frames, iters = drive(st1, 600, n_frames=600, thinning=1,
                             unif3=unif3[1200:], n01=n01[1200:],
                             return_iters=True)
    assert int(iters.max()) <= rows - 1200
    draws = frames["position"].reshape(-1, d).numpy()
    assert np.abs(draws.mean(axis=0)).max() < 0.1, draws.mean(axis=0)
    assert np.abs(draws.std(axis=0) - 1.0).max() < 0.1, draws.std(axis=0)


def _wall(d):
    """+inf off the origin: every angle is rejected."""
    return amt.Target(
        name="wall", dim=d,
        potential_fn=lambda x: torch.where(
            torch.sum(x * x, dim=-1) < 1e-12, 0.0, float("inf")),
        sites=(amt.models.SiteSpec("x", d, (d,)),))


@pytest.mark.parametrize("max_trips", [0, 3])
def test_plain_version_bailout_stays_put(max_trips):
    """test_pallas.py:469-500: every transition uses max_shrinkage_iters
    trips and bails out at theta = 0, so positions stay bit for bit; each
    transition then costs max_trips + 1 iterations."""
    d, C, n_steps = 3, 4, 5
    drive = k3.build_fused_asss(
        _wall(d), amt.ASSSConfig(max_shrinkage_iters=max_trips))
    x0 = torch.zeros(C, d)
    rng = np.random.default_rng(21)
    unif3 = torch.from_numpy(
        rng.uniform(1e-6, 1 - 1e-6, size=(200, 3, C)).astype(np.float32))
    n01 = torch.from_numpy(rng.normal(size=(200, d + 1, C))
                           .astype(np.float32))
    out, _, iters = drive((x0, torch.zeros(C), torch.zeros(C, d),
                           torch.eye(d).expand(C, d, d).contiguous(), 0,
                           torch.zeros(C)), n_steps, unif3=unif3, n01=n01,
                          return_iters=True)
    assert torch.equal(out[0], x0)
    assert int(out[4]) == n_steps
    assert iters.tolist() == [1 + n_steps * (max_trips + 1)] * C


def test_fused_rejects_targets_without_a_device_potential():
    """K3 runs a target on the card only if the target carries the tag of
    a device potential (``Target.device_potential``): the wrapper's check,
    which runs before any launch on a CUDA state, refuses untagged targets;
    the plain version runs them."""
    with pytest.raises(NotImplementedError):
        k3.check_device_potential(amt.std_normal(3), "fused ASSS")
    assert k3.check_device_potential(amt.eight_schools_noncentered(),
                                     "fused ASSS") \
        == "eight_schools_noncentered"
    k = amt.asss(amt.std_normal(3), amt.ASSSConfig(fused=True))
    st = k.step_n(k.init(torch.Generator().manual_seed(0), n_chains=2), 3,
                  torch.Generator().manual_seed(1))
    assert int(st.i) == 3


# the targets both fused kernels run on the card, by their device-potential
# tag
TAGGED = {
    "eight_schools_noncentered": amt.eight_schools_noncentered,
    "eight_schools_centered": amt.eight_schools_centered,
    "kidiq": amt.kidiq,
    "diamonds_ss": amt.diamonds,
}
UNTAGGED = {
    "diamonds_dense": lambda: amt.diamonds(suff_stats=False),
    "mvn": lambda: amt.mvn(np.zeros(3), np.eye(3)),
    "std_normal": lambda: amt.std_normal(3),
    "gaussian_mixture_1d": amt.gaussian_mixture_1d,
}


@pytest.mark.parametrize("kernel", ["fused ASSS", "fused ARWMH"])
@pytest.mark.parametrize("name", sorted(UNTAGGED))
def test_device_potential_gate_refuses_untagged_targets(name, kernel):
    """The gate reads the tag, not the name: the dense diamonds form has
    the name of the sufficient-statistic form but no device twin."""
    t = UNTAGGED[name]()
    assert t.device_potential is None
    with pytest.raises(NotImplementedError):
        k3.check_device_potential(t, kernel)


@pytest.mark.parametrize("tag", sorted(TAGGED))
def test_device_potential_gate_accepts_tagged_targets(tag):
    t = TAGGED[tag]()
    assert t.device_potential == tag
    assert k3.check_device_potential(t, "fused ASSS") == tag
    assert k3.check_device_potential(t, "fused ARWMH") == tag
    assert amt.arwmh(t, amt.ARWMHConfig(fused=True)).step_n is not None


def test_drive_leaves_the_callers_state_unchanged():
    """The kernel updates chains-last copies in place; the caller's tensors
    must not change."""
    _, state, unif3, n01 = _inputs(C=4, rows=300, seed=5)
    state = _torch_state(state)
    before = [t.clone() if isinstance(t, torch.Tensor) else t for t in state]
    drive = k3.build_fused_asss(amt.eight_schools_noncentered(),
                                amt.ASSSConfig())
    drive(state, 6, 2, 3, unif3=torch.from_numpy(unif3),
          n01=torch.from_numpy(n01))
    drive(state, 6, generator=torch.Generator().manual_seed(0))
    for a, b in zip(state, before):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_drive_checks_its_arguments():
    _, state, unif3, n01 = _inputs(C=4, rows=10, seed=6)
    state = _torch_state(state)
    drive = k3.build_fused_asss(amt.eight_schools_noncentered(),
                                amt.ASSSConfig())
    with pytest.raises(ValueError):
        drive(state, 4)                                   # no draws
    with pytest.raises(ValueError):
        drive(state, 4, unif3=torch.from_numpy(unif3))    # n01 missing
    with pytest.raises(ValueError):
        drive(state, 4, 2, 3, generator=torch.Generator())   # 6 > 4 steps
    with pytest.raises(ValueError):
        drive(state, 4, unif3=torch.from_numpy(unif3[:, :, :3]),
              n01=torch.from_numpy(n01[:, :, :3]))
