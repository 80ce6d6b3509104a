"""The kidiq configuration of the benchmark against the port (CPU): the
float64 reference (``benchmark/reference/targets/kidiq.py``, loaded by
path) against the port's ``amt.kidiq()`` potential, the vendored data
against ``models.data.kidiq()``, the exact gold against its own seed, the
OLS fit and a second quadrature of log sigma, and the port's plain ASSS
path against the gold."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import integrate, optimize

torch = pytest.importorskip("torch")

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.models import data as port_data  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import arwmh, potentials  # noqa: E402
from benchmark.registry import load_module  # noqa: E402

BENCH = ROOT / "benchmark"
REF = load_module(BENCH / "reference" / "targets" / "kidiq.py",
                  "benchmark_reference_target_kidiq_test")
CONFIG = dict(json.loads((BENCH / "configs" / "kidiq.json").read_text()),
              data_dir=str(BENCH / "data"))
GOLD = np.load(BENCH / "data" / CONFIG["gold"])
# The port sums the 434 float32 terms in 14 running sums of at most 31
# terms, then the 14 sums in order: at most 31 + 14 roundings of half an
# ulp (2^-24) of the magnitude each, 2.7e-6 of it; bfloat16 rounds every
# term and constant to 2^-9
TOL = 3e-6


def _points() -> np.ndarray:
    """48 gold draws and 16 points 5 gold sd out, each coordinate's sign
    drawn, from one seed."""
    rng = np.random.default_rng(20261019)
    bulk = GOLD[rng.choice(len(GOLD), 48, replace=False)]
    signs = rng.choice([-1.0, 1.0], size=(16, 4))
    far = GOLD.mean(0) + 5.0 * GOLD.std(0) * signs
    return np.concatenate([bulk, far])


def test_port_potential_matches_the_float64_reference():
    x32 = torch.tensor(_points(), dtype=torch.float32)
    got = amt.kidiq().potential_fn(x32).double().numpy()
    x = x32.double().numpy()                 # the points the port saw
    ref, mag = potentials.potential(CONFIG, x, magnitude=True)
    gap = np.abs(got - ref) / np.maximum(1.0, mag)
    assert gap.max() <= TOL, gap.max()
    low = potentials.potential(CONFIG, x, "bfloat16")
    assert (np.abs(low - ref) / np.maximum(1.0, mag)).max() > 100 * TOL


def test_vendored_data_is_the_ports_fallback(monkeypatch):
    monkeypatch.delenv("MCMC_WORKDIR", raising=False)
    want = port_data.kidiq.__wrapped__()
    got = np.load(BENCH / "data" / CONFIG["data"])
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes()
    assert 3 * len(want["kid_score"]) == CONFIG["n_data"]


def test_gold_regenerates_bit_for_bit():
    g = REF.gold(CONFIG, CONFIG["gold_draws"], CONFIG["gold_seed"])
    assert g.shape == (CONFIG["gold_draws"], CONFIG["dim"])
    assert g.dtype == GOLD.dtype and g.tobytes() == GOLD.tobytes()


def _stats():
    return REF.statistics(REF.columns(CONFIG))


def test_gold_beta_mean_is_the_ols_fit():
    """β's posterior mean is b̂: the gold's mean within 4 Monte Carlo
    standard errors of it."""
    _, b_hat, _ = _stats()
    beta = GOLD[:, :3]
    se = beta.std(0) / math.sqrt(len(beta))
    assert np.all(np.abs(beta.mean(0) - b_hat) <= 4 * se), \
        (beta.mean(0) - b_hat) / se


def test_gold_log_sigma_quantiles_by_a_second_quadrature():
    """log σ's 5, 50 and 95% quantiles against those of σ's marginal
    density p(σ) ∝ HC(σ; 2.5) σ^(3−N) exp(−SSE_min / 2σ²), integrated by
    adaptive Gauss–Kronrod (scipy's quad) in σ and inverted by Brent's
    method, within 4 Monte Carlo standard errors: √(p(1−p)/n) over the
    density of log σ at the quantile."""
    _, _, sse = _stats()
    n = float(CONFIG["N"])

    def log_p(sig):
        return (-math.log1p((sig / 2.5) ** 2) - (n - 3.0) * math.log(sig)
                - 0.5 * sse / sig ** 2)

    mode = optimize.minimize_scalar(lambda s: -log_p(s),
                                    bounds=(1.0, 100.0),
                                    method="bounded").x
    top = log_p(mode)

    def dens(sig):
        return math.exp(log_p(sig) - top)

    lo, hi = 0.5 * mode, 2.0 * mode
    z = integrate.quad(dens, lo, hi, points=[mode], epsabs=0,
                       epsrel=1e-12, limit=200)[0]

    def cdf(sig):
        return integrate.quad(dens, lo, sig, epsabs=0, epsrel=1e-12,
                              limit=200)[0] / z

    s = GOLD[:, 3]
    for p in (0.05, 0.5, 0.95):
        q = optimize.brentq(lambda sig: cdf(sig) - p, lo, hi, xtol=1e-12)
        f_s = dens(q) * q / z                  # density of log σ there
        se = math.sqrt(p * (1 - p) / len(s)) / f_s
        assert abs(np.quantile(s, p) - math.log(q)) <= 4 * se, \
            (p, np.quantile(s, p), math.log(q), se)


def test_plain_asss_keeps_the_gold():
    """The port's plain ASSS path (``ASSSConfig(fused=False)``, the
    pipelined machine on the CPU; K3 has no CPU path) through MCMC.run,
    256 chains started at gold draws, 1000 + 1000 steps, thinning 10: the
    pooled draws' law_gap (mean, sd and quantiles in gold sd) under 0.2.
    The transition keeps the posterior, so its draws stay on the gold; on
    seven seeds it read 0.064–0.092, its Monte Carlo error at 25600
    correlated draws."""
    rng = np.random.default_rng(7)
    init = torch.tensor(GOLD[rng.choice(len(GOLD), 256, replace=False)],
                        dtype=torch.float32)
    kernel = amt.asss(amt.kidiq(),
                      amt.ASSSConfig(num_warmup=1000, fused=False))
    mcmc = amt.MCMC(kernel, num_warmup=1000, num_samples=1000, thinning=10,
                    n_chains=256)
    mcmc.run(torch.Generator().manual_seed(7), init_position=init)
    x = mcmc.get_samples(group_by_chain=True,
                         flat_unconstrained=True).numpy()
    assert x.shape == (100, 256, 4) and np.isfinite(x).all()
    assert arwmh.law_gap(x, GOLD) < 0.2
