"""The PosteriorDB posteriors on the port's samplers: the plain versions of
the fused kernels K3 and K2 against the Pallas kernels in interpret mode
(as tests/test_torch_asss_fused.py and tests/test_torch_arwmh.py hold them
for eight-schools noncentered), and every driver of the port on each
target.

Both sides take the same state and the same injected draws, made with
numpy from a seed.  K3: chained transitions, compared normwise per field at
rtol 2e-4, atol 2e-5 (max|got - want| <= atol + rtol * max|want|; float32
rounding of the two packages compounds over the chain, XLA contracting
multiply-adds).  K2: normwise too, at the tolerance of its eight-schools
parity, rtol 2e-5, atol 2e-6, and at K3's for kidiq (see ``K2_TOL``).  The
starting states sit where each posterior puts its mass, under a scale of
the posterior's size, as after warmup."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu.kernels.arwmh import (  # noqa: E402
    ARWMHConfig as JARWMHConfig,
)
from adaptive_mcmc_tpu.kernels.asss import ASSSConfig as JASSSConfig  # noqa
from adaptive_mcmc_tpu.ops.pallas.arwmh_fused import (  # noqa: E402
    build_fused_arwmh as jbuild_arwmh,
)
from adaptive_mcmc_tpu.ops.pallas.asss_fused import (  # noqa: E402
    build_fused_asss as jbuild_asss,
)
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused as k2  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3  # noqa: E402

K3_RTOL, K3_ATOL = 2e-4, 2e-5
# K2 (rtol, atol): eight-schools' tolerance, and for kidiq that of K3, since
# one ulp of kidiq's U ~ 1750 is 1.2e-4 and moves exp(U - U') by as much.
# Diamonds' U ~ 3300 has an ulp of 2.4e-4, and the JAX potential sums
# Lᵀ(b − b̂) as a matrix product in its own order: the two U differ by a few
# ulps from the first step, which the running mean acceptance and log
# lambda take directly (4e-4 of them after one step), so 1e-3, four ulps.
K2_TOL = {"eight_schools_centered": (2e-5, 2e-6), "kidiq": (2e-4, 2e-5),
          "diamonds": (1e-3, 1e-4)}
# K2 steps: diamonds (d = 26) is slow in interpret mode
K2_STEPS = {"diamonds": 8}
NAMES = ("x", "pe", "loc", "scale", "i", "as_change")
# kidiq posterior sds of (beta, log sigma), about
KIDIQ_SD = np.array([9.0, 2.3, 0.06, 0.035])


def assert_close_normwise(got, want, rtol, atol, err=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err
    assert np.isfinite(got).all() and np.isfinite(want).all(), err
    bound = atol + rtol * np.max(np.abs(want))
    worst = np.max(np.abs(got - want))
    assert worst <= bound, f"{err}: max abs error {worst} > {bound}"


def _start(name, C, seed):
    """(x, loc, lower scale factor) near the posterior, float32."""
    rng = np.random.default_rng(seed)
    if name == "diamonds":
        gold = np.load(amt.models.data.DATA_DIR
                       / "diamonds.npy").astype(np.float64)
        x = gold[rng.choice(len(gold), C, replace=False)]
        loc = np.broadcast_to(gold.mean(0), x.shape)
        S = np.linalg.cholesky(np.cov(gold.T))
    elif name == "kidiq":
        mean = np.array([26.0, 6.0, 0.6, np.log(17.5)])
        x = mean + rng.normal(size=(C, 4)) * KIDIQ_SD
        loc = np.broadcast_to(mean, x.shape)
        S = np.diag(KIDIQ_SD)
    else:
        x = rng.normal(size=(C, 10)) * 0.5
        x[:, 0] += 4.0
        x[:, 2:] += 4.0
        loc = np.broadcast_to(x.mean(0), x.shape)
        S = np.eye(10)
    d = x.shape[1]
    S = np.broadcast_to(S, (C, d, d))
    return tuple(np.ascontiguousarray(a, np.float32) for a in (x, loc, S))


def _asss_inputs(name, C=8, rows=600, seed=0):
    jt = getattr(jm, name)()
    x, loc, S = _start(name, C, seed)
    pe = np.asarray(jax.vmap(jt.potential_fn)(jnp.asarray(x)))
    rng = np.random.default_rng(seed + 100)
    unif3 = rng.uniform(1e-6, 1 - 1e-6, size=(rows, 3, C)).astype(np.float32)
    n01 = rng.normal(size=(rows, jt.dim + 1, C)).astype(np.float32)
    return jt, (x, pe, loc, S, 0, np.zeros(C, np.float32)), unif3, n01


def _torch(state):
    return tuple(torch.tensor(a) if isinstance(a, np.ndarray) else a
                 for a in state)


# target, steps.  Diamonds (d = 26) is slow in interpret mode.  Kidiq's
# scales span 257x: after the adaptation clock restarts at num_warmup = 10
# (gamma = 1 makes the factor rank one) the float32 drift between the two
# packages grows fast, from 2e-5 of the bound at 16 steps to past it by 25.
@pytest.mark.parametrize("name,n_steps", [
    ("kidiq", 16), ("eight_schools_centered", 25), ("diamonds", 8),
])
def test_k3_plain_version_matches_pallas_kernel(name, n_steps):
    """State for state, no frames (one chunk, so the Pallas kernel
    consumes the rows the port does)."""
    jt, state, unif3, n01 = _asss_inputs(name)
    want, _ = jbuild_asss(jt, JASSSConfig(num_warmup=10))(
        tuple(jnp.asarray(a) for a in state), n_steps,
        unif3=jnp.asarray(unif3), n01=jnp.asarray(n01), interpret=True)
    t = getattr(amt, name)()
    got, frames, iters = k3.build_fused_asss(t, amt.ASSSConfig(
        num_warmup=10))(_torch(state), n_steps, unif3=torch.from_numpy(unif3),
                        n01=torch.from_numpy(n01), return_iters=True)
    assert frames == {}
    assert int(iters.max()) <= unif3.shape[0], "draw rows exhausted"
    assert int(iters.min()) >= n_steps + 1
    assert int(got[4]) == n_steps
    assert bool((got[0] != torch.from_numpy(state[0])).any(dim=1).all())
    for g, w, field in zip(got, want, NAMES):
        assert_close_normwise(g.numpy(), w, K3_RTOL, K3_ATOL, field)


def test_k3_plain_version_collect_matches_pallas_kernel_kidiq():
    """One single-chunk collect (F = 4, thinning 3) on kidiq: state and
    frames; the last frame is the final state."""
    jt, state, unif3, n01 = _asss_inputs("kidiq", seed=3)
    F, thin = 4, 3
    want_state, want = jbuild_asss(jt, JASSSConfig(num_warmup=6))(
        tuple(jnp.asarray(a) for a in state), F * thin, n_frames=F,
        thinning=thin, unif3=jnp.asarray(unif3), n01=jnp.asarray(n01),
        interpret=True)
    got_state, got = k3.build_fused_asss(
        amt.kidiq(), amt.ASSSConfig(num_warmup=6))(
            _torch(state), F * thin, F, thin, unif3=torch.from_numpy(unif3),
            n01=torch.from_numpy(n01))
    for g, w, field in zip(got_state, want_state, NAMES):
        assert_close_normwise(g.numpy(), w, K3_RTOL, K3_ATOL, field)
    for k in ("position", "potential_energy", "as_change"):
        assert_close_normwise(got[k].numpy(), want[k], K3_RTOL, K3_ATOL, k)
    np.testing.assert_array_equal(got["position"][:, -1].numpy(),
                                  got_state[0].numpy())


def _arwmh_inputs(name, C=9, S=12, seed=1):
    """The state of ``_start`` under its scale factor, with loc at x."""
    jt = getattr(jm, name)()
    x, _, L = _start(name, C, seed)
    pe = np.asarray(jax.vmap(jt.potential_fn)(jnp.asarray(x)))
    d = jt.dim
    tup = (x, pe, np.zeros(C, np.float32), x.copy(), L,
           np.zeros(C, np.float32), 0)
    rng = np.random.default_rng(seed + 100)
    noise = rng.normal(size=(S, C, d)).astype(np.float32)
    unif = rng.uniform(size=(S, C)).astype(np.float32)
    return jt, tup, noise, unif


@pytest.mark.parametrize("name", ["kidiq", "eight_schools_centered",
                                  "diamonds"])
def test_k2_plain_version_matches_pallas_kernel(name):
    """Injected draws, 12 steps (diamonds 8) across the warmup boundary:
    state for state, normwise per field (``K2_TOL``).  At kidiq's
    |U| ~ 1750 one ulp of U (1.2e-4) moves exp(U - U') by 1.2e-4 of
    itself: the running mean acceptance takes that directly, and through
    log lambda every later proposal, as test_torch_arwmh.py explains for
    eight-schools at |U| ~ 50.  The JAX side is the Pallas K2, which takes
    d = 26 once asked for (``ARWMHConfig(fused=True)``)."""
    S = K2_STEPS.get(name, 12)
    jt, tup, noise, unif = _arwmh_inputs(name, S=S)
    want, _ = jbuild_arwmh(jt, JARWMHConfig(num_warmup=4))(
        tuple(jnp.asarray(a) for a in tup), S, 0, 1,
        noise=jnp.asarray(noise), unif=jnp.asarray(unif), interpret=True)
    state = tuple(torch.tensor(np.asarray(a)) for a in tup[:6]) \
        + (torch.tensor(0, dtype=torch.int32),)
    got, _ = k2.build_fused_arwmh(getattr(amt, name)(), amt.ARWMHConfig(
        num_warmup=4))(state, S, 0, 1, noise=torch.from_numpy(noise),
                       unif=torch.from_numpy(unif))
    accepted = (got[0] != state[0]).any(dim=1)
    assert 0 < int(accepted.sum()) < 9 * S
    for g, w, field in zip(got, want, ("x", "pe", "map", "loc", "L",
                                       "loglam", "i", "as_change")):
        assert_close_normwise(g.numpy(), np.asarray(w), *K2_TOL[name],
                              field)


DRIVERS = ("asss_lockstep", "asss_pipelined", "asss_fused",
           "arwmh_lockstep", "arwmh_fused")


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("name", ["eight_schools_centered", "kidiq",
                                  "diamonds"])
def test_every_driver_runs_each_target(name, driver):
    """A short MCMC run of each driver on the CPU (the fused kernels' plain
    versions): finite draws of the right shape and the step counter; K2
    runs diamonds (d = 26) too."""
    t = getattr(amt, name)()
    kind, mode = driver.split("_")
    if kind == "arwmh":
        kernel = amt.arwmh(t, amt.ARWMHConfig(fused=mode == "fused"))
        assert (kernel.step_n is not None) == (mode == "fused")
    else:
        kernel = amt.asss(t, amt.ASSSConfig(fused=mode == "fused"))
        if mode == "lockstep":
            kernel = dataclasses.replace(kernel, step_n=None,
                                         collect_n=None)
    g = torch.Generator().manual_seed(4)
    samples, _, last = amt.run_mcmc(kernel, g, 6, 8, thinning=2, n_chains=3)
    assert samples.shape == (4, 3, t.dim)
    assert bool(torch.isfinite(samples).all())
    assert int(last.i) == 14
