"""Port parity for the ARWMH kernel: the lockstep step against the JAX step
on replayed draws, the fused drive's plain version against the Pallas fused
kernel in interpret mode, and the statistical checks of test_arwmh.py on
the port.

Tolerance rtol 2e-5, atol 2e-6 (that of test_pallas.py's fused parity):
the two packages round the n^-r power, the rank-1 recursion and the
potential's transcendentals differently in float32 (XLA also contracts
multiply-adds).  A single step is compared element by element.  Over a
chained trajectory those one-ulp differences compound: exp(U - U') at
|U| ~ 50 turns one ulp of U into ~4e-6 of the acceptance probability, which
moves log lambda and then every later proposal by ~1e-6 of the proposal's
scale.  An entry near zero then carries the error of its field's scale, so
chained trajectories are compared normwise: max|got - want| <= atol +
rtol * max|want| per field, with the same rtol and atol."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu import models as jm  # noqa: E402
from adaptive_mcmc_tpu.kernels.arwmh import (  # noqa: E402
    ARWMHConfig as JConfig,
    arwmh as j_arwmh,
)
from adaptive_mcmc_tpu.kernels.base import split_keys  # noqa: E402
from adaptive_mcmc_tpu.ops.pallas.arwmh_fused import (  # noqa: E402
    build_fused_arwmh as jbuild_fused,
)
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused as k2  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6


def replay_draws(keys, n_steps: int, d: int):
    """Walk the JAX lockstep step's key chain (kernels/arwmh.py step):
    returns the (T, C, d) normals and (T, C) uniforms it draws."""
    noise, unif = [], []
    for _ in range(n_steps):
        keys, k_prop, k_acc = split_keys(keys, 3)
        noise.append(jax.vmap(lambda k: jax.random.normal(k, (d,)))(k_prop))
        unif.append(jax.vmap(jax.random.uniform)(k_acc))
    return np.stack(noise), np.stack(unif)


def assert_close_normwise(got, want, rtol=RTOL, atol=ATOL, err=""):
    """max|got - want| <= atol + rtol * max|want| over the finite entries,
    with the same non-finite pattern."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=err)
    if fin.any():
        bound = atol + rtol * np.max(np.abs(want[fin]))
        worst = np.max(np.abs(got[fin] - want[fin]))
        assert worst <= bound, f"{err}: max abs error {worst} > {bound}"


def _fields(state):
    a = state.adapt_state
    return {"position": state.position,
            "potential_energy": state.potential_energy,
            "mean_accept_prob": state.mean_accept_prob,
            "as_change": state.as_change, "loc": a.loc, "scale": a.scale,
            "log_step_size": a.log_step_size}


def assert_states_close(ts, js, err="", normwise=False):
    jn = jax.tree.map(np.asarray, js)
    tn = interop.arwmh_state_to_numpy(ts)
    assert int(tn.i) == int(jn.i), err
    want = _fields(jn)
    for name, got in _fields(tn).items():
        if normwise:
            assert_close_normwise(got, want[name], err=f"{err} {name}")
        else:
            np.testing.assert_allclose(got, want[name], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{err} {name}")


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_jax_on_replayed_draws(seed):
    """20 lockstep steps across the warmup boundary (num_warmup=4) from the
    converted JAX init state, fed the JAX step's own draws: every step taken
    from the JAX state before it matches element by element, the chained
    trajectory matches normwise, and the accept decisions are identical."""
    C, T = 9, 20
    jt = jm.eight_schools_noncentered()
    jk = j_arwmh(jt, JConfig(num_warmup=4))
    tk = amt.arwmh(amt.eight_schools_noncentered(),
                   amt.ARWMHConfig(num_warmup=4))
    js = jk.init(jax.random.PRNGKey(seed), n_chains=C)
    ts = interop.arwmh_state_from_numpy(jax.tree.map(np.asarray, js))
    assert_states_close(ts, js, "init")
    noise, unif = replay_draws(js.rng_key, T, jt.dim)
    n_moves = 0
    for t in range(T):
        draws = dict(noise=torch.from_numpy(noise[t]),
                     unif=torch.from_numpy(unif[t]))
        one = tk.step(
            interop.arwmh_state_from_numpy(jax.tree.map(np.asarray, js)),
            **draws)
        js_new = jk.step(js)
        ts_new = tk.step(ts, **draws)
        assert_states_close(one, js_new, f"step {t} from the JAX state")
        assert_states_close(ts_new, js_new, f"chained step {t}",
                            normwise=True)
        moved_j = np.any(np.asarray(js_new.position)
                         != np.asarray(js.position), axis=1)
        moved_t = torch.any(ts_new.position != ts.position, dim=1).numpy()
        np.testing.assert_array_equal(moved_t, moved_j, err_msg=f"step {t}")
        n_moves += int(moved_j.sum())
        js, ts = js_new, ts_new
    assert 0 < n_moves < C * T


def _fused_inputs(C, S, seed):
    jt = jm.eight_schools_noncentered()
    d = jt.dim
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(C, d)).astype(np.float32)
    pe = np.asarray(jax.vmap(jt.potential_fn)(jnp.asarray(x)))
    L = np.broadcast_to(np.eye(d, dtype=np.float32), (C, d, d)).copy()
    tup = (x, pe, np.zeros(C, np.float32), x.copy(), L,
           np.zeros(C, np.float32), 0)
    noise = rng.normal(size=(S, C, d)).astype(np.float32)
    unif = rng.uniform(size=(S, C)).astype(np.float32)
    return jt, tup, noise, unif


def _torch_tuple(tup):
    return tuple(torch.tensor(np.asarray(a)) for a in tup[:6]) \
        + (torch.tensor(tup[6], dtype=torch.int32),)


def test_fused_plain_version_matches_pallas_kernel():
    """Injected draws: the plain version of K2 against the Pallas fused
    kernel in interpret mode, state for state (test_pallas.py:104-129)."""
    C, S = 9, 12
    jt, tup, noise, unif = _fused_inputs(C, S, seed=1)
    jcfg = JConfig(num_warmup=4)
    want, _ = jbuild_fused(jt, jcfg)(
        tuple(jnp.asarray(a) for a in tup), S, 0, 1,
        noise=jnp.asarray(noise), unif=jnp.asarray(unif), interpret=True)
    drive = k2.build_fused_arwmh(amt.eight_schools_noncentered(),
                                 amt.ARWMHConfig(num_warmup=4))
    got, frames = drive(_torch_tuple(tup), S, 0, 1,
                        noise=torch.from_numpy(noise),
                        unif=torch.from_numpy(unif))
    assert frames == {}
    for g, w, name in zip(got, want,
                          ("x", "pe", "map", "loc", "L", "loglam", "i",
                           "as_change")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert int(got[6]) == S


def test_fused_plain_version_frames_match_pallas_kernel():
    """Frame layout and values (test_pallas.py:131-164): (C, F, d) and
    (C, F); the last frame is the final state; the state equals the
    frameless run on the same draws."""
    C, S, F, thin = 5, 20, 4, 5
    jt, tup, noise, unif = _fused_inputs(C, S, seed=2)
    jcfg = JConfig(num_warmup=0)
    want_state, want = jbuild_fused(jt, jcfg)(
        tuple(jnp.asarray(a) for a in tup), S, F, thin,
        noise=jnp.asarray(noise), unif=jnp.asarray(unif), interpret=True)
    drive = k2.build_fused_arwmh(amt.eight_schools_noncentered(),
                                 amt.ARWMHConfig(num_warmup=0))
    args = dict(noise=torch.from_numpy(noise), unif=torch.from_numpy(unif))
    st_a, frames = drive(_torch_tuple(tup), S, F, thin, **args)
    st_b, _ = drive(_torch_tuple(tup), S, 0, 1, **args)
    for a, b in zip(st_a, st_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert frames["position"].shape == (C, F, jt.dim)
    assert frames["potential_energy"].shape == (C, F)
    assert frames["as_change"].shape == (C, F)
    for k in ("position", "potential_energy", "as_change"):
        np.testing.assert_allclose(frames[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(frames["position"][:, -1].numpy(),
                                  st_a[0].numpy())
    np.testing.assert_array_equal(frames["as_change"][:, -1].numpy(),
                                  st_a[7].numpy())
    np.testing.assert_allclose(st_a[0].numpy(), np.asarray(want_state[0]),
                               rtol=RTOL, atol=ATOL)


def test_fused_drive_leaves_the_callers_state_unchanged():
    """The kernel updates its chains-last copies in place; the caller's
    tensors must not change (a kernel run followed by its plain version on
    the same state is how the two are compared)."""
    _, tup, noise, unif = _fused_inputs(4, 6, seed=3)
    state = _torch_tuple(tup)
    before = [t.clone() for t in state]
    drive = k2.build_fused_arwmh(amt.eight_schools_noncentered(),
                                 amt.ARWMHConfig())
    drive(state, 6, 2, 3, noise=torch.from_numpy(noise),
          unif=torch.from_numpy(unif))
    drive(state, 6, generator=torch.Generator().manual_seed(0))
    for a, b in zip(state, before):
        assert torch.equal(a, b)


def test_fused_rejects_targets_without_a_device_potential():
    with pytest.raises(NotImplementedError):
        amt.arwmh(amt.std_normal(3), amt.ARWMHConfig(fused=True))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_acceptance_rate_converges_to_target():
    k = amt.arwmh(amt.std_normal(5), amt.ARWMHConfig(num_warmup=0))
    _, _, last = amt.run_mcmc(k, _gen(3), num_warmup=0, num_samples=6000,
                              n_chains=8)
    acc = float(torch.mean(last.mean_accept_prob))
    assert 0.18 < acc < 0.30, acc


def test_posterior_moments_std_normal():
    k = amt.arwmh(amt.std_normal(2), amt.ARWMHConfig(num_warmup=2000))
    samples, _, _ = amt.run_mcmc(k, _gen(4), num_warmup=2000,
                                 num_samples=4000, n_chains=32)
    flat = samples.reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(0).numpy(), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(flat.std(0).numpy(), np.ones(2), atol=0.08)


def test_warmup_clock_reset():
    """gamma right after warmup equals gamma at n=1: loc jumps all the way
    to the new position."""
    k = amt.arwmh(amt.std_normal(2), amt.ARWMHConfig(num_warmup=5))
    g = _gen(5)
    st = k.init(g, n_chains=1)
    for _ in range(5):
        st = k.step(st, g)
    assert int(st.i) == 5
    st2 = k.step(st, g)
    np.testing.assert_allclose(st2.adapt_state.loc[0].numpy(),
                               st2.position[0].numpy(), rtol=1e-6)
    st3 = k.step(st2, g)   # n=2: gamma = 2^(-2/3) < 1
    delta = st3.position[0] - st2.adapt_state.loc[0]
    np.testing.assert_allclose(
        st3.adapt_state.loc[0].numpy(),
        (st2.adapt_state.loc[0] + 2.0 ** (-2.0 / 3.0) * delta).numpy(),
        rtol=1e-5, atol=1e-7,
    )


def test_rwm_fixed_proposal_never_adapts():
    k = amt.rwm(amt.std_normal(3), step_size=0.8)
    g = _gen(6)
    st = k.init(g, n_chains=2)
    a0 = st.adapt_state
    for _ in range(10):
        st = k.step(st, g)
    np.testing.assert_array_equal(st.adapt_state.scale.numpy(),
                                  a0.scale.numpy())
    np.testing.assert_array_equal(st.adapt_state.log_step_size.numpy(),
                                  a0.log_step_size.numpy())
    np.testing.assert_allclose(a0.log_step_size.numpy(), np.log(0.8),
                               rtol=1e-6)
    assert float(torch.mean(st.mean_accept_prob)) > 0.0


# -- the step's operations around the potential: plain on the CPU ---------

def _inline_step(config, potential, state, noise, u):
    """The lockstep step written out as one sequence of PyTorch operators:
    what the step's plain propose / accept / K1 / settle must compose to on
    a CPU state, bit for bit."""
    from adaptive_mcmc_tpu_torch.kernels.base import adaptation_lr, nan_to_inf
    from adaptive_mcmc_tpu_torch.ops.cholesky import adaptive_scale_update
    loc, L, log_lam = state.adapt_state
    x, pe = state.position, state.potential_energy
    C, d = x.shape
    step_size = torch.exp(log_lam)
    x_prop = x + torch.einsum(
        "cij,cj->ci",
        L * step_size[:, None, None] + config.eps * torch.eye(d), noise)
    pe_prop = nan_to_inf(potential(x_prop))
    accept_prob = torch.exp(pe - pe_prop).clamp_max(1.0)
    accepted = u < accept_prob
    x_new = torch.where(accepted[:, None], x_prop, x)
    pe_new = torch.where(accepted, pe_prop, pe)
    n, gamma = adaptation_lr(state.i, config.num_warmup, config.lr_decay)
    mean_ap = state.mean_accept_prob
    mean_new = mean_ap + (accept_prob - mean_ap) / n.to(torch.float32)
    if not config.adapt:
        return (x_new, pe_new, mean_new, loc, L, log_lam,
                torch.zeros_like(pe), state.i + 1)
    delta = x_new - loc
    L_new = adaptive_scale_update(L, delta, gamma.expand(C))
    log_lam_new = log_lam + gamma * (accept_prob - config.target_accept_prob)
    as_change = torch.linalg.matrix_norm(
        L_new * torch.exp(log_lam_new)[:, None, None]
        - L * step_size[:, None, None])
    return (x_new, pe_new, mean_new, loc + gamma * delta, L_new, log_lam_new,
            as_change, state.i + 1)


@pytest.mark.parametrize("adapt", [True, False])
def test_cpu_step_runs_the_plain_ops_and_launches_nothing(adapt):
    """A CPU state takes the plain propose / accept / settle (and K1's plain
    version): 12 steps across the warmup boundary equal the step written
    out as one sequence of operators, bit for bit, and no kernel's launch
    count moves."""
    from adaptive_mcmc_tpu_torch.ops.cuda import launch_counts
    t = amt.eight_schools_noncentered()
    config = amt.ARWMHConfig(num_warmup=5, adapt=adapt)
    k = amt.arwmh(t, config)
    g = _gen(31)
    state = k.init(g, n_chains=16)
    before = launch_counts()
    for _ in range(12):
        noise = torch.randn((16, t.dim), generator=g)
        u = torch.rand((16,), generator=g)
        want = _inline_step(config, t.potential_fn, state, noise, u)
        state = k.step(state, None, noise, u)
        a = state.adapt_state
        got = (state.position, state.potential_energy,
               state.mean_accept_prob, a.loc, a.scale, a.log_step_size,
               state.as_change, state.i)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert launch_counts() == before


def test_step_kernels_refuse_a_cpu_state():
    from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_step
    C, d = 4, 3
    with pytest.raises(ValueError, match="CUDA"):
        arwmh_step.propose(torch.zeros(C, d), torch.zeros(C, d, d),
                           torch.zeros(C), torch.zeros(C, d), 1e-6)


@pytest.mark.parametrize("lr_decay,mode", [
    (2.0 / 3.0, 0), (0.6, 0), (1.0, 1), (0.5, 2)])
def test_accept_kernel_takes_torchs_power_for_each_lr_decay(lr_decay, mode):
    """gamma = n^(-lr_decay) in the accept kernel goes the way
    adaptation_lr goes on CUDA for that lr_decay (its 1 / n at 1, the rsqrt
    of PyTorch's pow at 0.5, else powf), with the exponent rounded to
    float32."""
    from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_step
    got_mode, exponent = arwmh_step.pow_mode(lr_decay)
    assert got_mode == mode
    assert exponent == float(np.float32(-lr_decay))
