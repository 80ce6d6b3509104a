"""The port's figure families (``analysis/figures.py``) against the JAX
package's ``analysis/figures.py``.

* The registry has JAX's keys in its order, and each family draws JAX's
  file names: the JAX family runs with its rollouts and estimators
  stubbed out (inside this test only) and its ``savefig`` recorded; the
  port's draws from the card's committed data
  (``mcmc_runs/torch_h100/figures/``, ``--data-only`` output of an H100
  run), each SVG parsed as XML.
* The card's numbers hold the checks the theory fixes
  (``figures.theory_gates``).
* Each family's data on the CPU at small sizes has the layout of the
  card's, and the command line computes and draws on the CPU.
* In distribution against the JAX primitives at small sizes: frozen
  ASSS's mean and 5/25/75/95% bands on the mixture per probe (the mean
  within 4 Monte-Carlo standard errors of the difference; each port
  quantile at a JAX empirical CDF within 4 standard errors of its level,
  sqrt(q (1 − q) (1/n + 1/n))); the acceptance rate per step size within
  0.02; adaptation_drift's log-log slope over the last decade within
  0.15 (the slopes are about −a; 32 chains leave some 0.05 of noise).
"""

import subprocess
import sys
import types
from pathlib import Path
from xml.etree import ElementTree

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("matplotlib")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.figure  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu.analysis import figures as jf  # noqa: E402
from adaptive_mcmc_tpu_torch.analysis import figures as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CARD = ROOT / "mcmc_runs" / "torch_h100" / "figures"
FAMILIES = list(tf.ALL_FIGURES)
# the CPU sizes of each family's data
TINY = {
    "invariance": dict(n=500),
    "accept_rate": dict(n_iters=20, n_chains=8),
    "pnx": dict(n_samples=100),
    "contraction": dict(n_samples=100),
    "kernel_distance": dict(sample_batch_size=20, n_eval_batches=1,
                            max_steps=1),
    "adaptation_drift": dict(n_pow=1),
    "sss_x_contraction": dict(n_samples=100, n_points=4),
    "sss_contraction": dict(n_samples=50, n_points=3),
    "sss_kernel_distance": dict(sample_batch_size=20, n_eval_batches=1,
                                max_steps=1),
    "x_step": dict(n_samples=50, n_points=4),
    "x_step_grids": dict(n_samples=50, n_points=4),
    "x_wasserstein": dict(n_samples=100, n_points=4),
    "x_contraction": dict(n_samples=100, n_points=4),
    "contraction_decrease": dict(n_samples=50, n_points=3),
    "kernel_dist_families": dict(sample_batch_size=20, n_eval_batches=1,
                                 max_steps=1),
    "contraction_dual": dict(n_points=5, sample_batch_size=20,
                             n_train_batches=1, n_pf_samples=20),
}
# the JAX families' own size arguments, cut (their rollouts are stubbed)
JAX_SMALL = {"invariance": dict(n=10),
             "accept_rate": dict(n_iters=1, n_chains=2),
             **{name: dict(n_samples=10) for name in (
                 "pnx", "contraction", "sss_x_contraction",
                 "sss_contraction", "x_step", "x_step_grids",
                 "x_wasserstein", "x_contraction", "contraction_decrease")}}


def _card(name: str) -> dict:
    return tf.load_data(CARD / f"{name}.npz")


def _zeros_pnx(kernel, key, x, adapt, n=1, n_samples=1, **kw):
    return jnp.zeros((x.shape[0], n_samples, x.shape[1]))


@pytest.fixture
def stubbed_jax(monkeypatch):
    """The JAX figure module with every rollout and estimator replaced by
    zeros of its shape, and savefig recording file names."""
    from adaptive_mcmc_tpu import contraction as jco
    from adaptive_mcmc_tpu.analysis import contraction_curves as jcc
    from adaptive_mcmc_tpu.infer import mcmc as jmc
    from adaptive_mcmc_tpu.metrics import sliced as jsl

    zeros_of = lambda xs: jnp.zeros(jnp.asarray(xs).shape[0])  # noqa: E731
    monkeypatch.setattr(jf, "taus_finite_difference_arctan",
                        lambda k, key, xs, a, **kw: zeros_of(xs))
    monkeypatch.setattr(jcc, "taus_finite_difference",
                        lambda k, key, xs, a, **kw: zeros_of(xs))
    monkeypatch.setattr(jf, "contraction_decay_curve",
                        lambda k, key, xs, a, ns=(1,), **kw:
                        jnp.zeros(len(ns)))
    monkeypatch.setattr(jf, "compute_kernel_distance_1d",
                        lambda *a, **kw: (0.0, None, None))
    monkeypatch.setattr(jf, "make_sample_px",
                        lambda k, a: lambda key, X, n:
                        _zeros_pnx(k, key, X, a, n_samples=n))
    monkeypatch.setattr(jf, "push_through_kernel",
                        lambda k, key, exact, n_steps=1: exact)
    monkeypatch.setattr(
        jf, "collect_states_logscale",
        lambda k, key, n_pow, n_chains: (types.SimpleNamespace(
            as_change=jnp.ones((len(jamt.ns_logscale(n_pow)), n_chains))),
            None))
    monkeypatch.setattr(jmc, "sample_pnx", _zeros_pnx)
    monkeypatch.setattr(jsl, "wasserstein_1d",
                        lambda Px, pi: jnp.zeros(Px.shape[0]))
    monkeypatch.setattr(jco, "compute_wasserstein_contraction",
                        lambda *a, **kw: (0.0, None, None))
    monkeypatch.setattr(jco, "apply_lipschitz_mlp",
                        lambda params, X: jnp.zeros(X.shape[:-1]))
    names = []
    real = matplotlib.figure.Figure.savefig
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, fname, **kw:
                        names.append(Path(fname).name))

    def unstub_savefig() -> None:
        monkeypatch.setattr(matplotlib.figure.Figure, "savefig", real)

    return names, unstub_savefig


def test_registry_has_the_jax_keys_in_order():
    assert FAMILIES == list(jf.ALL_FIGURES)
    assert len(FAMILIES) == 16


@pytest.mark.parametrize("name", FAMILIES)
def test_family_draws_the_jax_file_names_from_the_cards_data(
        name, tmp_path, stubbed_jax):
    """The JAX family (stubbed) and the port's drawing of the committed
    card data write the same SVG names; each port SVG parses as XML."""
    names, unstub_savefig = stubbed_jax
    jf.ALL_FIGURES[name](tmp_path, **JAX_SMALL.get(name, {}))
    want = sorted(names)
    unstub_savefig()
    out = tmp_path / "torch"
    tf.main(out, only={name}, from_data=CARD)
    got = sorted(f.name for f in out.glob("*.svg"))
    assert got == want and got
    for f in out.glob("*.svg"):
        assert ElementTree.parse(f).getroot().tag.endswith("svg")


def test_the_cards_numbers_hold_the_theory_gates():
    gates = tf.theory_gates({n: _card(n) for n in FAMILIES})
    assert len(gates) == 9
    failed = [g for g in gates if not g[3]]
    assert not failed, failed


@pytest.mark.parametrize("name", FAMILIES)
def test_cpu_data_has_the_layout_of_the_cards(name):
    """data_<family> at small sizes on the CPU: the card's keys, finite
    numbers, and the probe grids of the card's data where those do not
    depend on the sizes."""
    data = tf.ALL_FIGURES[name][0](device="cpu", seed=0, **TINY[name])
    card = _card(name)
    assert set(data) == set(card)
    for key, v in data.items():
        v = np.asarray(v)
        assert v.dtype.kind == card[key].dtype.kind, key
        assert v.ndim == card[key].ndim, key
        if v.dtype.kind == "f":
            assert np.all(np.isfinite(v)), key
    for key in ("edges", "scales", "sigmas", "locs", "ns"):
        if key in data and name != "adaptation_drift":
            np.testing.assert_array_equal(data[key], card[key])


def test_command_line_data_only_then_from_data_on_the_cpu(tmp_path):
    """``--device cpu --data-only`` writes the family's npz (figures.py's
    default sizes), ``--from-data`` draws it under JAX's name."""
    run = [sys.executable, "-m", "adaptive_mcmc_tpu_torch.analysis.figures"]
    subprocess.run(run + [str(tmp_path / "d"), "pnx", "--device", "cpu",
                          "--data-only"], cwd=ROOT, check=True,
                   capture_output=True, timeout=300)
    assert [f.name for f in (tmp_path / "d").iterdir()] == ["pnx.npz"]
    subprocess.run(run + [str(tmp_path / "img"), "pnx", "--from-data",
                          str(tmp_path / "d")], cwd=ROOT, check=True,
                   capture_output=True, timeout=300)
    assert [f.name for f in (tmp_path / "img").iterdir()] == \
        ["pnx-distributions.svg"]
    d = tf.load_data(tmp_path / "d" / "pnx.npz")
    assert int(d["n64.counts"].sum(axis=1).max()) <= 20_000


def test_quantiles_equal_jnp_quantile():
    x = np.random.default_rng(0).normal(size=(5, 1001)).astype(np.float32)
    want = np.asarray(jnp.quantile(jnp.asarray(x),
                                   jnp.array(tf.QUANTILES), axis=1))
    np.testing.assert_allclose(tf.quantiles(torch.tensor(x)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loc,n", [(0.0, 1), (1.0, 2), (0.0, 5)])
def test_frozen_asss_bands_on_the_mixture_match_jax(loc, n):
    """Frozen ASSS on the mixture, 6 probes on [−5, 5], 4000 samples each:
    the port's x_step data against JAX's sample_pnx."""
    m = 4000
    data = tf.data_x_step(device="cpu", seed=3, n_samples=m, n_points=6)
    stem = tf._x_step_stem("sss", "mixture", loc, n)
    k, adapt = jf._frozen_1d("sss", "mixture", loc=loc)
    xs = jnp.linspace(-5, 5, 6)
    Px = np.asarray(jamt.sample_pnx(k, jax.random.PRNGKey(4), xs[:, None],
                                    adapt, n=n, n_samples=m))[:, :, 0]
    se = np.sqrt(Px.var(1) / m + Px.var(1) / m)
    assert np.all(np.abs(data[f"{stem}.mean"] - Px.mean(1)) <= 4 * se)
    for j, q in enumerate(tf.QUANTILES):
        level = np.mean(Px <= data[f"{stem}.q"][j][:, None], axis=1)
        assert np.all(np.abs(level - q) <= 4 * np.sqrt(q * (1 - q) * 2 / m))


def test_accept_rate_matches_jax():
    """300 steps of 128 chains per step size: the port's rates against the
    JAX family's loop."""
    got = tf.data_accept_rate(device="cpu", n_iters=300, n_chains=128)
    # one frozen kernel (adapt=False): the step size lives in the adapt
    # state, so one compiled loop serves every scale
    k, _ = jf._frozen_arwmh(jamt.models.std_normal(1))
    run = jax.jit(lambda adapt: jax.lax.fori_loop(
        0, 300, lambda _, x: k.step(x),
        k.init(jax.random.PRNGKey(1), n_chains=128, adapt_state=adapt)))
    want = []
    for s in got["scales"]:
        _, adapt = jf._frozen_arwmh(jamt.models.std_normal(1), step=float(s))
        adapt = jax.tree.map(lambda a: jnp.repeat(a, 128, axis=0), adapt)
        want.append(float(jnp.mean(run(adapt).mean_accept_prob)))
    np.testing.assert_allclose(got["rates"], want, atol=0.02)


def test_adaptation_drift_slope_matches_jax():
    """The log-log slope of the mean as_change over n in [100, 1000] per
    lr_decay, 32 chains on centered eight schools, within 0.15."""
    got = tf.data_adaptation_drift(device="cpu", n_pow=3, n_chains=32)
    ns = got["ns"]
    last = ns >= 100
    for decay, _ in tf.DRIFT_DECAYS:
        k = jamt.arwmh(jamt.models.eight_schools_centered(),
                       jamt.ARWMHConfig(lr_decay=decay))
        states, _ = jamt.collect_states_logscale(k, jax.random.PRNGKey(2),
                                                 n_pow=3, n_chains=32)
        jd = np.asarray(jnp.mean(states.as_change, axis=1))
        slope = [np.polyfit(np.log(ns[last]), np.log(d[last]), 1)[0]
                 for d in (got[f"a{decay:.3g}"], jd)]
        assert abs(slope[0] - slope[1]) <= 0.15, (decay, slope)
