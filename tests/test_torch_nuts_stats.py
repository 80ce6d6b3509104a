"""Statistical parity for the port's NUTS: tests/test_nuts.py ported, at
its bands, on analytically known targets (std normal, a dense
correlated Gaussian, the quadrature truths of eight schools and kidiq from
adaptive_mcmc_tpu.experiments.quadrature), the tree-depth bound,
divergences, energy conservation at a tiny step, the U-turn checkpoint
indexing against brute force, the pipelined step_n against the lockstep
step, and pi P = pi for the frozen pipelined kernel (KS test).  The runs
use the port's drivers on the CPU with a seeded torch.Generator.  The
eager machine costs 2-6 ms per trip on a CPU, and a warmup's first
transitions build the deepest trees, so the runs are shorter than JAX's,
warmups above all, with more chains where a band needs the draws; the
kidiq truth test is marked slow (its docstring says why)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.infer.diagnostics import (  # noqa: E402
    gelman_rubin,
)
from adaptive_mcmc_tpu_torch.models.base import SiteSpec, Target  # noqa: E402

tn = importlib.import_module("adaptive_mcmc_tpu_torch.kernels.nuts")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_std_normal_posterior():
    t = amt.std_normal(5)
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=40))
    samples, _, last = amt.run_mcmc(k, _gen(0), num_warmup=40,
                                    num_samples=60, n_chains=64)
    flat = samples.reshape(-1, 5).double()
    np.testing.assert_allclose(flat.mean(0).numpy(), np.zeros(5), atol=0.1)
    np.testing.assert_allclose(flat.std(0).numpy(), np.ones(5), atol=0.1)
    assert float(gelman_rubin(samples).max()) < 1.1
    acc = float(last.mean_accept_prob.mean())
    assert 0.55 < acc < 0.99, acc


def test_correlated_gaussian_dense_mass():
    rho = 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]])
    t = amt.mvn(np.zeros(2), np.linalg.cholesky(cov))
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=250, dense_mass=True))
    samples, _, last = amt.run_mcmc(k, _gen(1), num_warmup=250,
                                    num_samples=100, n_chains=32)
    flat = samples.reshape(-1, 2).double().numpy()
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.15)
    # the adapted dense inverse mass is the covariance, about
    np.testing.assert_allclose(last.adapt_state.inv_mass.mean(0).numpy(),
                               cov, atol=0.3)


def test_num_steps_bounded_by_tree_depth():
    k = amt.nuts(amt.std_normal(3),
                 amt.NUTSConfig(num_warmup=50, max_tree_depth=6))
    _, extras, _ = amt.run_mcmc(k, _gen(2), num_warmup=50, num_samples=25,
                                n_chains=4, extra_fields=("num_steps",))
    assert int(extras["num_steps"].max()) <= 2 ** 6
    assert int(extras["num_steps"].min()) >= 1


def test_divergences_on_funnel_like_target():
    """Neal's funnel without reparametrization: the diverging flag is a
    bool trajectory, and the run stays finite."""
    def potential(x):
        v, theta = x[:, 0], x[:, 1:]
        return (0.5 * (v / 3.0) ** 2
                + 0.5 * torch.sum(theta ** 2, dim=-1) * torch.exp(-v)
                + 0.5 * (x.shape[1] - 1) * v)

    t = Target(name="funnel", dim=5, potential_fn=potential,
               sites=(SiteSpec("x", 5, (5,)),))
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=30, max_tree_depth=6))
    samples, extras, _ = amt.run_mcmc(k, _gen(3), num_warmup=30,
                                      num_samples=30, n_chains=8,
                                      extra_fields=("diverging",))
    assert extras["diverging"].dtype == torch.bool
    assert extras["diverging"].shape == (30, 8)
    assert torch.isfinite(samples).all()


def test_eight_schools_runs_and_converges():
    t = amt.eight_schools_noncentered()
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=60))
    samples, _, _ = amt.run_mcmc(k, _gen(4), num_warmup=60,
                                 num_samples=25, n_chains=64)
    assert torch.isfinite(samples).all()
    sites = t.constrain(samples.reshape(-1, t.dim))
    mu_mean = float(sites["mu"].mean())
    tau_med = float(sites["tau"].median())
    assert 2.0 < mu_mean < 7.0, mu_mean
    assert 1.0 < tau_med < 8.0, tau_med


def test_energy_conservative_for_tiny_steps():
    """A tiny fixed step and no adaptation: acceptance about 1."""
    cfg = amt.NUTSConfig(step_size=1e-3, adapt_step_size=False,
                         adapt_mass_matrix=False, num_warmup=0,
                         max_tree_depth=4)
    _, _, last = amt.run_mcmc(amt.nuts(amt.std_normal(4), cfg), _gen(5),
                              num_warmup=0, num_samples=20, n_chains=4)
    assert float(last.mean_accept_prob.min()) > 0.99
    assert bool((last.num_steps == 15).all())


def test_uturn_checkpoint_indexing_vs_bruteforce():
    """The port's checkpoint tables: at odd leaf n the subtrees (n+1-2^k ..
    n), k = 1..trailing ones of n, read the slots their first leaves
    pushed to, and no leaf in between overwrote them."""
    slot_t, trail_t = tn.checkpoint_tables(6)
    for num_leaves in (2, 4, 8, 16, 32, 64):
        slot_of = {}
        for n in range(num_leaves):
            slot = int(slot_t[n])
            if n % 2 == 0:
                slot_of[n] = slot
                continue
            for k in range(1, int(trail_t[n]) + 1):
                first = n + 1 - 2 ** k
                read_slot = slot - (k - 1)
                assert read_slot == slot_of[first], (n, k)
                for m2 in range(first + 2, n, 2):
                    assert slot_of[m2] != slot_of[first], (n, k, m2)


def test_eight_schools_quadrature_truth():
    """E[log tau], sd(log tau) and E[mu] against the 2-D quadrature truths
    (test_nuts.py's bands)."""
    from adaptive_mcmc_tpu.experiments.quadrature import eight_schools_truth

    truth = eight_schools_truth()
    t = amt.eight_schools_noncentered()
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=150))
    samples, _, _ = amt.run_mcmc(k, _gen(3), num_warmup=150,
                                 num_samples=50, n_chains=256)
    s = samples.reshape(-1, t.dim).double().numpy()
    assert abs(s[:, 1].mean() - truth["mean_log_tau"]) < 0.045, \
        s[:, 1].mean()
    assert abs(s[:, 1].std() - truth["sd_log_tau"]) < 0.06, s[:, 1].std()
    assert abs(s[:, 0].mean() - truth["mean_mu"]) < 0.25, s[:, 0].mean()


@pytest.mark.slow
def test_kidiq_quadrature_truth():
    """Slow on the CPU: kidiq's scales differ 250-fold, so until the first
    mass-matrix window closes every transition builds the whole
    1023-leapfrog tree, tens of thousands of eager machine trips.  The
    same truths gate NUTS on kidiq on the card (chip_smoke.py)."""
    from adaptive_mcmc_tpu.experiments.quadrature import kidiq_truth

    truth = kidiq_truth()
    t = amt.kidiq()
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=500))
    samples, _, _ = amt.run_mcmc(k, _gen(11), num_warmup=500,
                                 num_samples=150, n_chains=32)
    s = samples.reshape(-1, t.dim).double().numpy()
    np.testing.assert_allclose(
        s[:, :3].mean(0), truth["mean_beta"],
        atol=float(4 * truth["sd_beta"].max() / np.sqrt(500) + 0.05))
    assert abs(s[:, 3].mean() - truth["mean_log_sigma"]) < 0.015


def test_step_n_matches_sync_statistically():
    """The pipelined step_n samples what n lockstep steps sample, the
    adaptation's end state included (test_nuts.py's bands).  After the
    warmup each driver's positions are pooled from every tenth transition
    (NUTS draws ten transitions apart are all but independent), so 256
    chains and 100 transitions hold the bands that JAX's single final
    positions need 600 for."""
    t = amt.eight_schools_noncentered()
    warmup, n, every = 60, 100, 10
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=warmup))
    s0 = k.init(_gen(3), n_chains=256)
    g = _gen(4)
    s_sync, sync = s0, []
    for i in range(1, n + 1):
        s_sync = k.step(s_sync, g)
        if i > warmup and (i - warmup) % every == 0:
            sync.append(s_sync.position)
    g = _gen(5)
    s_async = k.step_n(s0, warmup, g)
    pipelined = []
    for _ in range((n - warmup) // every):
        s_async = k.step_n(s_async, every, g)
        pipelined.append(s_async.position)
    assert int(s_async.i) == int(s_sync.i) == n
    a, b = torch.cat(sync).double(), torch.cat(pipelined).double()
    np.testing.assert_allclose(a.mean(0).numpy(), b.mean(0).numpy(),
                               atol=0.5)
    np.testing.assert_allclose(a.std(0).numpy(), b.std(0).numpy(),
                               rtol=0.35, atol=0.15)
    eps = [float(torch.exp(s.adapt_state.da.log_eps_avg).mean())
           for s in (s_sync, s_async)]
    assert abs(np.log(eps[1]) - np.log(eps[0])) < 0.35, eps
    np.testing.assert_allclose(s_sync.adapt_state.inv_mass.mean(0).numpy(),
                               s_async.adapt_state.inv_mass.mean(0).numpy(),
                               rtol=0.5, atol=0.1)
    for s in (s_sync, s_async):
        ap = float(s.mean_accept_prob.mean())
        assert 0.6 < ap < 0.99, ap


def test_step_n_frozen_kernel_invariance():
    """pi P = pi for pipelined transitions with adaptation frozen: exact
    std-normal starts, 3 transitions, a KS test of the pooled draws."""
    import scipy.stats

    k = amt.nuts(amt.std_normal(2), amt.NUTSConfig(
        num_warmup=0, adapt_step_size=False, adapt_mass_matrix=False,
        step_size=0.5))
    n = 8192
    exact = torch.randn((n, 2), generator=_gen(21))
    state = k.init(_gen(22), n_chains=n, position=exact)
    out = k.step_n(state, 3, _gen(23))
    ks = scipy.stats.kstest(out.position.reshape(-1).double().numpy(),
                            "norm")
    assert ks.pvalue > 1e-3, ks
    assert not torch.equal(out.position, exact)
