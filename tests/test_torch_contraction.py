"""The port's Lipschitz-NN contraction estimators against the JAX
package's (CPU): spectral_norm and the MLP on carried parameters (rtol
1e-6), the pair mask exactly, and the trainers on key-independent samples
(a fixed numpy noise array) from carried initial parameters.  The
smooth-max loss and its gradient at the carried parameters equal JAX's
(the loss at rtol 1e-6, every gradient component within 1e-4 of the
largest: float32 sums over 1536 samples), and the optimiser equals
optax.adam with the ±1 clip on a loss whose gradients are well above
Adam's eps (rtol 1e-6 after 20 steps).  After 20 training steps τ is
within rtol 1e-3 of JAX's and the trained f (up to its constant, which no
ratio sees) within 5e-3 on a grid; single parameters are not compared
there: this objective has gradient components near or below Adam's eps =
1e-8 (a sum that cancels is 0 in one package and rounding noise in the
other), and Adam's normalised step moves such a component by up to
lr · |g| / (|g| + eps) either way, so single parameters part by 1e-3 to
0.1 within a few steps while f and τ stay put.  Then the analytic checks
of tests/test_contraction.py on the port's own generator: the AR(1) band
(τ = ρ exactly), identical kernels (ρ = 0), a contraction difference, the
1-D estimator and make_sample_px's common random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from adaptive_mcmc_tpu.contraction import lipschitz as jl  # noqa: E402

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.contraction import lipschitz as tl  # noqa: E402
from adaptive_mcmc_tpu_torch.contraction import (  # noqa: E402
    compute_kernel_distance,
    compute_kernel_distance_1d,
    compute_wasserstein_contraction,
    make_sample_px,
)

# τ and the trained f on a grid after 20 training steps
TRAIN_RTOL, F_ATOL, STEPS = 1e-3, 5e-3, 20
GRID = np.linspace(-3, 3, 61, dtype=np.float32)[:, None]


def _carry(params):
    return interop.mlp_from_numpy(jax.tree.map(np.asarray, params))


def _ar1(rho, sigma):
    """P(x, ·) = N(ρx, σ²): τ(P) = |ρ| exactly."""
    def sample_px(seed, X, n_samples):
        g = torch.Generator(X.device).manual_seed(seed)
        noise = torch.randn((X.shape[0], n_samples, X.shape[1]),
                            generator=g, device=X.device)
        return rho * X[:, None, :] + sigma * noise

    return sample_px


@pytest.mark.parametrize("scale", [3.0, 0.05])
def test_spectral_norm_matches_jax(scale):
    """Above norm 1 it shrinks to σ_max = 1; below, the matrix is
    untouched: JAX's values at rtol 1e-6."""
    w = (np.random.default_rng(0).standard_normal((16, 8)) * scale) \
        .astype(np.float32)
    got = tl.spectral_norm(torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.spectral_norm(w)),
                               rtol=1e-6, atol=1e-7)
    assert np.linalg.svd(got, compute_uv=False)[0] < 1.05
    if scale < 1:
        np.testing.assert_allclose(got, w, rtol=1e-6)


def test_mlp_matches_jax_and_is_lipschitz():
    params = jl.init_lipschitz_mlp(jax.random.PRNGKey(1), 3)
    mlp = _carry(params)
    assert [tuple(w.shape) for w in mlp.weights] == [(3, 32), (32, 32),
                                                    (32, 1)]
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((200, 3)) * 5.0).astype(np.float32)
    y = x + (rng.standard_normal((200, 3)) * 0.1).astype(np.float32)
    fx = mlp(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(fx, np.asarray(jl.apply_lipschitz_mlp(params,
                                                                     x)),
                               rtol=1e-6, atol=1e-6)
    fy = mlp(torch.tensor(y)).detach().numpy()
    assert np.max(np.abs(fx - fy) / np.linalg.norm(x - y, axis=-1)) <= 1.05
    back = jl.MLPParams(*interop.mlp_to_numpy(mlp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("kind", ["grid", "cloud"])
def test_pair_mask_matches_jax(kind):
    if kind == "grid":
        X = np.linspace(-3, 3, 24, dtype=np.float32)[:, None]
    else:
        X = np.random.default_rng(3).standard_normal((30, 2)) \
            .astype(np.float32)
    dj, mj = jl._pair_mask(jnp.asarray(X))
    dt, mt = tl._pair_mask(torch.tensor(X))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < int(mt.sum()) < X.shape[0] ** 2


def test_loss_and_gradient_match_jax():
    """The τ trainer's smooth-max objective and its gradient at carried
    parameters, on the pair mask of 24 probe points."""
    X = np.linspace(-3, 3, 24, dtype=np.float32)[:, None]
    batch = 0.6 * X[:, None, :] + 0.4 * np.random.default_rng(4) \
        .standard_normal((24, 64, 1)).astype(np.float32)
    p0 = jl.init_lipschitz_mlp(jax.random.PRNGKey(6), 1)
    dj, mj = jl._pair_mask(jnp.asarray(X))
    dt, mt = tl._pair_mask(torch.tensor(X))

    def jloss(p):
        pf = jnp.mean(jl.apply_lipschitz_mlp(p, batch), -1)
        r = jnp.where(mj, jnp.abs(pf[:, None] - pf[None, :])
                      / jnp.where(mj, dj, 1.0), 0.0)
        return -jax.nn.logsumexp(10.0 * r) / 10.0

    mlp = _carry(p0)
    pf = torch.mean(mlp(torch.tensor(batch)), -1)
    r = torch.where(mt, torch.abs(pf[:, None] - pf[None, :])
                    / torch.where(mt, dt, 1.0), 0.0)
    loss = -torch.logsumexp((10.0 * r).reshape(-1), 0) / 10.0
    grads = torch.autograd.grad(loss, list(mlp.parameters()))
    lj, gj = jax.jit(jax.value_and_grad(jloss))(p0)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-6)
    scale = max(float(np.abs(b).max()) for b in jax.tree.leaves(gj))
    for a, b in zip(grads, jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * scale)


def test_optimizer_is_optax_adam_with_the_clip():
    """_adam_train against optax.adam(0.1) after clipping each gradient to
    ±1, on a quadratic whose gradients are O(1) (some clipped): 20 steps at
    rtol 1e-6; and the stop rule: a loss without gradient stops after one
    step."""
    import optax

    p0 = jl.init_lipschitz_mlp(jax.random.PRNGKey(2), 2, 8)
    targets = jax.tree.map(lambda a: np.full(a.shape, 0.7, np.float32), p0)

    def jloss(p):
        return sum(jnp.sum(3.0 * (a - t) ** 2) for a, t in
                   zip(jax.tree.leaves(p), jax.tree.leaves(targets)))

    opt = optax.adam(0.1)

    @jax.jit
    def step(params, state):
        g = jax.tree.map(lambda x: jnp.clip(x, -1.0, 1.0),
                         jax.grad(jloss)(params))
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state

    params, state = p0, opt.init(p0)
    for _ in range(20):
        params, state = step(params, state)
    mlp = _carry(p0)
    tt = [torch.tensor(t) for t in jax.tree.leaves(targets)]
    tl._adam_train(mlp, lambda: sum(torch.sum(3.0 * (a - t) ** 2) for a, t
                                    in zip(mlp.parameters(), tt)),
                   20, 0.1, 1e-10)
    for a, b in zip(jax.tree.leaves(jl.MLPParams(*interop.mlp_to_numpy(mlp))),
                    jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    calls = []
    still = _carry(p0)
    tl._adam_train(still, lambda: calls.append(1) or
                   0.0 * sum(p.sum() for p in still.parameters()),
                   20, 0.1, 1e-10)
    assert len(calls) == 1


def _fixed(seed, shape, rho, sigma):
    noise = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    return (lambda key, X, n: rho * X[:, None, :] + sigma * noise,
            lambda s, X, n: rho * X[:, None, :] + sigma * torch.tensor(noise))


def _assert_trained_alike(mlp, params):
    """f on GRID, up to its constant, within F_ATOL."""
    fj = np.asarray(jl.apply_lipschitz_mlp(params, GRID))
    ft = mlp(torch.tensor(GRID)).detach().numpy()
    np.testing.assert_allclose(ft - ft.mean(), fj - fj.mean(), rtol=0,
                               atol=F_ATOL)


def test_trainer_matches_jax_on_fixed_samples():
    """compute_kernel_distance with key-independent P and Q, from carried
    initial parameters: JAX's ρ and trained MLP."""
    X = np.linspace(-3, 3, 12, dtype=np.float32)[:, None]
    jp, tp = _fixed(0, (12, 64, 1), 0.7, 0.3)
    jq, tq = _fixed(1, (12, 64, 1), 0.2, 0.3)
    p0 = jl.init_lipschitz_mlp(jax.random.PRNGKey(3), 1)
    kw = dict(sample_batch_size=64, n_train_batches=2, n_eval_batches=3,
              max_steps=STEPS)
    rj, _, pj = jl.compute_kernel_distance(jp, jq, jax.random.PRNGKey(5),
                                           jnp.asarray(X), init_params=p0,
                                           **kw)
    rt, apply, pt = compute_kernel_distance(
        tp, tq, torch.Generator().manual_seed(0), X, init_params=_carry(p0),
        **kw)
    np.testing.assert_allclose(float(rt), float(rj), rtol=TRAIN_RTOL)
    _assert_trained_alike(pt, pj)
    assert apply(pt, torch.tensor(X)).shape == (12,)


def test_contraction_trainer_matches_jax_on_fixed_samples():
    """The τ trainer (_train_test_fn with the mean of two fixed batches, as
    compute_wasserstein_contraction's) from carried parameters: JAX's
    trained MLP, and the hard max ratio."""
    X = np.linspace(-2, 2, 10, dtype=np.float32)[:, None]
    noise = np.random.default_rng(4).standard_normal((2, 10, 48, 1)) \
        .astype(np.float32)
    p0 = jl.init_lipschitz_mlp(jax.random.PRNGKey(6), 1)
    dj, mj = jl._pair_mask(jnp.asarray(X))
    dt, mt = tl._pair_mask(torch.tensor(X))

    def jmean(params, key):
        return jnp.mean(jnp.stack([jnp.mean(jl.apply_lipschitz_mlp(
            params, 0.6 * X[:, None, :] + 0.4 * nz), -1) for nz in noise]), 0)

    def tmean(params, seeds):
        return torch.mean(torch.stack([torch.mean(params(
            0.6 * torch.tensor(X)[:, None, :] + 0.4 * torch.tensor(nz)), -1)
            for nz in noise]), 0)

    kw = dict(alpha=10.0, max_steps=STEPS, lr=0.1, num_features=32)
    pj, _ = jl._train_test_fn(jmean, jax.random.PRNGKey(0), jnp.asarray(X),
                              dj, mj, init_params=p0, **kw)
    pt = tl._train_test_fn(tmean, 2, torch.Generator().manual_seed(0),
                           torch.tensor(X), dt, mt, init_params=_carry(p0),
                           **kw)
    _assert_trained_alike(pt, pj)
    tau_j = jl._eval_max_ratio(lambda p, k: jmean(p, k), pj,
                               jax.random.PRNGKey(1), dj, mj, 2)
    tau_t = tl._eval_max_ratio(lambda p, s: tmean(p, [s]), pt,
                               torch.Generator().manual_seed(1), dt, mt, 2)
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=TRAIN_RTOL)


def test_kernel_distance_1d_matches_jax_on_fixed_samples():
    x = np.linspace(-2, 2, 12, dtype=np.float32)
    jp, tp = _fixed(5, (12, 128, 1), 0.9, 0.3)
    jq, tq = _fixed(6, (12, 128, 1), 0.5, 0.3)
    p0 = jl.init_lipschitz_mlp(jax.random.PRNGKey(7), 1)
    kw = dict(sample_batch_size=128, n_train_batches=1, n_eval_batches=2,
              max_steps=STEPS)
    rj, _, pj = jl.compute_kernel_distance_1d(jp, jq, jax.random.PRNGKey(7),
                                              jnp.asarray(x), init_params=p0,
                                              **kw)
    rt, _, pt = compute_kernel_distance_1d(
        tp, tq, torch.Generator().manual_seed(7), x, init_params=_carry(p0),
        **kw)
    np.testing.assert_allclose(float(rt), float(rj), rtol=TRAIN_RTOL)
    _assert_trained_alike(pt, pj)


@pytest.mark.parametrize("rho", [0.5, 0.9])
def test_contraction_gaussian_kernel(rho):
    """The AR(1) band of tests/test_contraction.py on the port's
    generator: 0.6ρ < τ < 1.15ρ."""
    tau, _, _ = compute_wasserstein_contraction(
        _ar1(rho, 0.3), torch.Generator().manual_seed(4),
        torch.linspace(-3, 3, 24)[:, None], sample_batch_size=256,
        n_train_batches=2, n_eval_batches=16, max_steps=60)
    assert 0.6 * rho < float(tau) < 1.15 * rho, float(tau)


def test_kernel_distance_identical_kernels_zero():
    rho, _, _ = compute_kernel_distance(
        _ar1(0.7, 0.3), _ar1(0.7, 0.3), torch.Generator().manual_seed(5),
        torch.linspace(-2, 2, 16)[:, None], sample_batch_size=128,
        n_train_batches=2, n_eval_batches=8, max_steps=30)
    assert float(rho) < 0.05


def test_kernel_distance_detects_a_contraction_difference():
    rho, _, _ = compute_kernel_distance(
        _ar1(0.9, 0.3), _ar1(0.5, 0.3), torch.Generator().manual_seed(6),
        torch.linspace(-2, 2, 16)[:, None], sample_batch_size=256,
        n_train_batches=2, n_eval_batches=16, max_steps=60)
    assert float(rho) > 0.1


def test_kernel_distance_1d_runs():
    rho, _, params = compute_kernel_distance_1d(
        _ar1(0.9, 0.3), _ar1(0.5, 0.3), torch.Generator().manual_seed(7),
        torch.linspace(-2, 2, 12), sample_batch_size=512,
        n_train_batches=1, n_eval_batches=8, max_steps=30)
    assert np.isfinite(float(rho)) and float(rho) >= 0.0
    assert isinstance(params, tl.LipschitzMLP)


def test_make_sample_px_common_random_numbers():
    """make_sample_px over a frozen ARWMH: (n_points, n_samples, d), the
    same seed gives the same draws, another seed others."""
    k, adapt = amt.analysis.frozen_arwmh(amt.std_normal(1), step=1.0)
    sample_px = make_sample_px(k, adapt, n=2)
    X = torch.linspace(-1, 1, 4)[:, None]
    a, b, c = sample_px(3, X, 50), sample_px(3, X, 50), sample_px(4, X, 50)
    assert a.shape == (4, 50, 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
