"""sample_pnx and the invariance and contraction-curve checks of the port
(CPU): the flattened point-major layout, the pinned adapt state and the
common random numbers of sample_pnx for every kernel family (ARWMH, RWM,
ASSS, NUTS, SA), frozen ARWMH's P⁵(x, ·) against JAX's (mean and sd within
5 Monte-Carlo standard errors) and its τ_x(P) likewise, ks_statistic equal
to JAX's, and the
checks of tests/test_analysis.py and tests/test_contraction.py on the
port's generator at ≤ 20000 samples."""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu.analysis import ks_statistic as j_ks  # noqa: E402

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.analysis import (  # noqa: E402
    contraction_decay_curve,
    frozen_arwmh,
    frozen_asss,
    invariance_ks,
    ks_null_threshold,
    ks_statistic,
    push_through_kernel,
    taus_finite_difference,
    taus_finite_difference_arctan,
)
from adaptive_mcmc_tpu_torch.infer.mcmc import map_state  # noqa: E402
from adaptive_mcmc_tpu_torch.kernels.base import Kernel  # noqa: E402

BUILDS = {
    "arwmh": amt.arwmh,
    "rwm": amt.rwm,
    "asss": amt.asss,
    "nuts": amt.nuts,
    "sa": lambda t: amt.sa(t, amt.SAConfig(adapt_state_size=16)),
}
X3 = [[0.0, 0.0], [3.0, 0.0], [0.0, -3.0]]


def _adapt(kernel):
    return amt.get_init_adapt_state(kernel, torch.Generator().manual_seed(3),
                                    position=torch.zeros(2))


@pytest.mark.parametrize("name", list(BUILDS))
def test_sample_pnx_layout_and_common_random_numbers(name):
    """(n_points, n_samples, d), finite, spread; n = 0 gives each point
    n_samples times (point-major); the same seed gives the same rollout,
    another seed and a generator's continuing draws others."""
    k = BUILDS[name](amt.std_normal(2))
    adapt = _adapt(k)
    x = torch.tensor(X3)
    out = amt.sample_pnx(k, 7, x, adapt, n=2, n_samples=16)
    assert out.shape == (3, 16, 2) and bool(torch.isfinite(out).all())
    assert float(out.std(dim=1).min()) > 0.0
    assert torch.equal(out, amt.sample_pnx(k, 7, x, adapt, n=2,
                                           n_samples=16))
    assert not torch.equal(out, amt.sample_pnx(k, 8, x, adapt, n=2,
                                               n_samples=16))
    g = torch.Generator().manual_seed(7)
    first = amt.sample_pnx(k, g, x, adapt, n=2, n_samples=16)
    assert not torch.equal(first, amt.sample_pnx(k, g, x, adapt, n=2,
                                                 n_samples=16))
    still = amt.sample_pnx(k, 7, x, adapt, n=0, n_samples=4)
    assert torch.equal(still, x[:, None, :].expand(3, 4, 2))


@pytest.mark.parametrize("name", ["arwmh", "asss", "nuts", "sa"])
def test_sample_pnx_pins_the_adapt_state(name):
    """sample_pnx equals the loop of the kernel's step from the flattened
    grid with i and the adapt state put back after every step (adaptive
    kernels first rebuilt with adapt=False), on the same draws."""
    k = BUILDS[name](amt.std_normal(2))
    adapt = _adapt(k)
    x = torch.tensor(X3)
    out = amt.sample_pnx(k, torch.Generator().manual_seed(11), x, adapt,
                         n=3, n_samples=8)
    if getattr(k.config, "adapt", False):
        k = BUILDS[name](amt.std_normal(2),
                         dataclasses.replace(k.config, adapt=False))
    adapt_b = map_state(lambda a: a.expand((24,) + tuple(a.shape[1:]))
                        .contiguous(), adapt)
    g = torch.Generator().manual_seed(11)
    s = k.init(g, n_chains=24, position=x.repeat_interleave(8, 0),
               adapt_state=adapt_b)
    for _ in range(3):
        s = k.step(s, g)._replace(i=s.i, adapt_state=adapt_b)
    assert torch.equal(out, s.position.reshape(3, 8, 2))


def test_sample_pnx_per_point_adapt_state():
    """An adapt state with one row per probe point: each point's chains
    move under its own step size (0 against 1)."""
    k, _ = frozen_arwmh(amt.std_normal(1))
    adapt = amt.ARWMHAdaptState(
        loc=torch.zeros((2, 1)), scale=torch.eye(1).expand(2, 1, 1),
        log_step_size=torch.tensor([-30.0, 0.0]))
    out = amt.sample_pnx(k, 1, torch.tensor([[0.5], [0.5]]), adapt, n=3,
                         n_samples=64)
    # the first moves by the eps I of the proposal scale alone
    assert float(out[0].std()) < 1e-4 < float(out[1].std())


def test_frozen_arwmh_p5_matches_jax_statistically():
    """Frozen ARWMH's P⁵(x, ·) on std_normal(2) from three points, 4000
    draws each: mean and sd per point and coordinate within 5 Monte-Carlo
    standard errors of JAX's."""
    S = 4000
    jk = jamt.arwmh(jamt.std_normal(2))
    ja = jamt.get_init_adapt_state(jk, jax.random.PRNGKey(3),
                                   position=jnp.zeros(2))
    want = np.asarray(jamt.sample_pnx(jk, jax.random.PRNGKey(4),
                                      jnp.asarray(X3), ja, n=5, n_samples=S))
    k = amt.arwmh(amt.std_normal(2))
    got = amt.sample_pnx(k, 4, torch.tensor(X3), _adapt(k), n=5,
                         n_samples=S).numpy()
    m_g, m_w = got.mean(1), want.mean(1)
    s_g, s_w = got.std(1), want.std(1)
    se_mean = np.sqrt((s_g**2 + s_w**2) / S)
    assert np.all(np.abs(m_g - m_w) < 5 * se_mean), (m_g, m_w)
    # sd of a sample sd about sd / sqrt(2S) (a normal's; P⁵ is near one)
    se_sd = np.sqrt((s_g**2 + s_w**2) / (2 * S))
    assert np.all(np.abs(s_g - s_w) < 5 * se_sd), (s_g, s_w)


def test_ks_statistic_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = (rng.standard_normal(2500) + 0.1).astype(np.float32)
    b[:10] = a[:10]                      # ties across the samples
    assert float(ks_statistic(torch.tensor(a), torch.tensor(b))) == \
        float(j_ks(jnp.asarray(a), jnp.asarray(b)))


def test_ks_statistic_calibration():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(20_000, generator=g)
    b = torch.randn(20_000, generator=g)
    assert float(ks_statistic(a, b)) < ks_null_threshold(20_000)
    assert float(ks_statistic(a, b + 0.2)) > ks_null_threshold(20_000)


def _normal(g, n):
    return torch.randn((n, 1), generator=g, device=g.device)


def _mixture(g, n):
    comp = torch.rand((n, 1), generator=g, device=g.device) < 0.5
    return torch.where(comp, 1.0, -1.0) \
        + 0.1 * torch.randn((n, 1), generator=g, device=g.device)


@pytest.mark.parametrize("build", [amt.arwmh, amt.asss])
def test_invariance_normal(build):
    ks = invariance_ks(build(amt.std_normal(1)), _normal,
                       torch.Generator().manual_seed(2), n_samples=20_000)
    assert ks < 1.5 * ks_null_threshold(20_000), ks


def test_invariance_mixture_arwmh():
    ks = invariance_ks(amt.arwmh(amt.gaussian_mixture_1d()), _mixture,
                       torch.Generator().manual_seed(3), n_samples=20_000)
    assert ks < 1.5 * ks_null_threshold(20_000), ks


def test_invariance_violated_for_wrong_target():
    """Negative control: N(0, 1) pushed through a kernel for N(2, 1) fails
    the check."""
    k = amt.arwmh(amt.mvn(np.array([2.0]), np.eye(1)))
    ks = invariance_ks(k, _normal, torch.Generator().manual_seed(4),
                       n_samples=20_000)
    assert ks > 3.0 * ks_null_threshold(20_000), ks


def test_push_through_kernel_defaults_to_the_initial_adapt_state():
    x = torch.linspace(-1, 1, 50)[:, None]
    out = push_through_kernel(amt.arwmh(amt.std_normal(1)), 5, x)
    assert out.shape == (50, 1) and not torch.equal(out, x)


def test_contraction_decays_below_one():
    k, adapt = frozen_arwmh(amt.std_normal(1), step=1.0)
    taus = contraction_decay_curve(
        k, torch.Generator().manual_seed(5), torch.linspace(-2, 2, 5), adapt,
        ns=(1, 4, 16), n_samples=4000).numpy()
    assert taus[0] < 1.0 and taus[-1] < taus[0], taus


def test_taus_finite_difference_matches_jax_statistically():
    """τ_x(P) of frozen ARWMH at five probes, 10000 draws: the max over the
    probes within 0.05 of JAX's (its Monte-Carlo sd is about 0.01 in
    either package, over 30 seeds), every probe within 0.15."""
    from adaptive_mcmc_tpu.analysis.contraction_curves import (
        taus_finite_difference as j_taus,
    )
    from adaptive_mcmc_tpu.analysis.figures import _frozen_arwmh

    jk, ja = _frozen_arwmh(jamt.std_normal(1), step=1.0)
    want = np.asarray(j_taus(jk, jax.random.PRNGKey(3),
                             jnp.linspace(-2, 2, 5), ja, n_samples=10_000))
    k, adapt = frozen_arwmh(amt.std_normal(1), step=1.0)
    got = taus_finite_difference(k, 3, torch.linspace(-2, 2, 5), adapt,
                                 n_samples=10_000).numpy()
    assert abs(got.max() - want.max()) < 0.05, (got, want)
    np.testing.assert_allclose(got, want, atol=0.15)


class _AR1State(NamedTuple):
    i: torch.Tensor
    position: torch.Tensor
    adapt_state: object


def _ar1_kernel(rho, sigma):
    """x' = ρx + σ N(0, 1): τ(P^n) = ρ^n in any probe parameterisation."""
    def init(generator, n_chains, position=None, adapt_state=None):
        return _AR1State(torch.zeros((), dtype=torch.int32), position,
                         adapt_state)

    def step(s, generator):
        noise = torch.randn(s.position.shape, generator=generator)
        return s._replace(i=s.i + 1, position=rho * s.position
                          + sigma * noise)

    @dataclasses.dataclass(frozen=True)
    class Cfg:
        pass

    return Kernel(name="ar1", target=None, config=Cfg(), init=init,
                  step=step)


def test_arctan_taus_analytic_ar1():
    rho = 0.8
    k = _ar1_kernel(rho, 0.5)
    adapt = amt.ASSSAdaptState(loc=torch.zeros((1, 1)),
                               scale=torch.eye(1)[None])
    xs = torch.tan(torch.linspace(-np.arctan(2.0), np.arctan(2.0), 7))
    for n in (1, 3):
        taus = taus_finite_difference_arctan(
            k, torch.Generator().manual_seed(0), xs, adapt, n_steps=n,
            n_samples=2000)
        np.testing.assert_allclose(taus.numpy(), rho**n, rtol=0.05)


def test_asss_arctan_taus_below_one():
    """Frozen ASSS on N(0, 1): τ(P) and τ(P⁶) below one.  Whether τ(P⁶) <
    τ(P) is Monte-Carlo noise at 4000 draws, in the JAX package too (its
    test holds on its seed; seeds 0, 2 and 3 give τ(P⁶) > τ(P))."""
    k, adapt = frozen_asss(amt.std_normal(1))
    xs = torch.tan(torch.linspace(-np.arctan(2.0), np.arctan(2.0), 9))
    t1 = taus_finite_difference_arctan(k, 1, xs, adapt, n_steps=1,
                                       n_samples=4000)
    t6 = taus_finite_difference_arctan(k, 1, xs, adapt, n_steps=6,
                                       n_samples=4000)
    assert float(t1.max()) < 1.0 and float(t6.max()) < 1.0
