"""The figure families of the study (PyTorch): the counterpart of
``adaptive_mcmc_tpu/analysis/figures.py``, split in two.

Each of the 16 families of :data:`ALL_FIGURES` (the JAX package's keys, in
its order) has

* ``data_<family>(device, seed, **sizes) -> dict`` — the rollouts and the
  reductions the figure plots, computed on ``device`` (the card by
  default): means and the 5/25/75/95% quantile bands per probe, τ curves
  and ρ values, histogram counts over fixed bin edges, acceptance rates
  and ``as_change`` on the log grid.  A flat dict of numpy arrays, which
  ``--data-only`` writes as ``<family>.npz``.  The sizes are keyword
  arguments with ``figures.py``'s own defaults.
* ``draw_<family>(data, out_dir)`` — the figure, drawn with matplotlib
  into the JAX package's file names.  matplotlib is imported only there,
  so the module imports where it is missing.

Every probe array is built on the run's device: ``sample_pnx`` and the
contraction curves run on the device of their probe points.

Run:  python -m adaptive_mcmc_tpu_torch.analysis.figures [out_dir]
[family ...] [--device cpu] [--data-only] [--from-data DIR]
(out_dir defaults to ``mcmc_runs/torch/img`` under
``experiments.configs.OUT_ROOT``).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.analysis.contraction_curves import (
    contraction_decay_curve,
    frozen_arwmh,
    frozen_asss,
    taus_finite_difference,
    taus_finite_difference_arctan,
)
from adaptive_mcmc_tpu_torch.analysis.invariance import (
    ks_null_threshold,
    ks_statistic,
    push_through_kernel,
)
from adaptive_mcmc_tpu_torch.contraction import (
    apply_lipschitz_mlp,
    compute_kernel_distance_1d,
    compute_wasserstein_contraction,
    make_sample_px,
)
from adaptive_mcmc_tpu_torch.experiments.configs import OUT_ROOT
from adaptive_mcmc_tpu_torch.infer.collect import (
    collect_states_logscale,
    ns_logscale,
)
from adaptive_mcmc_tpu_torch.infer.mcmc import (
    MAX_GRAPH_STEPS,
    advancer,
    map_state,
    sample_pnx,
)
from adaptive_mcmc_tpu_torch.kernels.arwmh import ARWMHConfig, arwmh
from adaptive_mcmc_tpu_torch.kernels.asss import asss
from adaptive_mcmc_tpu_torch.metrics.sliced import wasserstein_1d
from adaptive_mcmc_tpu_torch.models import (
    eight_schools_centered,
    gaussian_mixture_1d,
    std_normal,
)

Tensor = torch.Tensor

OUT_DIR = Path(OUT_ROOT) / "img"
QUANTILES = (0.05, 0.25, 0.75, 0.95)
SIGMAS = (0.1, 1.0, 10.0)
SIGMA_COLORS = ("orange", "blue", "red")
KD_SCALES = (0.25, 0.5, 1.0, 2.0, 4.0)


# ---------------------------------------------------------------------------
# Shared pieces.
# ---------------------------------------------------------------------------

def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def _arctan_probe_grid(n: int = 50, lim: float = 2.5, device=None) -> Tensor:
    """x = tan(φ) probe grid, dense near the mode, thin in the tails (the
    reference's SSS probe layout), on ``device``."""
    phis = np.linspace(-np.arctan(lim), np.arctan(lim), n)
    return torch.tensor(np.tan(phis), dtype=torch.float32, device=device)


def _linspace(a: float, b: float, n: int, device) -> Tensor:
    return torch.linspace(a, b, n, device=device)


def _target_1d(tname: str):
    return std_normal(1) if tname == "normal" else gaussian_mixture_1d()


def _exact_1d_samples(tname: str, generator, n: int) -> Tensor:
    """Exact draws (n,) from the synthetic 1-D targets (the normal, and the
    mixture ½N(−1, 0.1²) + ½N(1, 0.1²)), on the generator's device."""
    dev = generator.device
    if tname == "normal":
        return torch.randn((n,), generator=generator, device=dev)
    comp = torch.rand((n,), generator=generator, device=dev) < 0.5
    eps = torch.randn((n,), generator=generator, device=dev)
    return torch.where(comp, 1.0, -1.0) + 0.1 * eps


def _frozen_1d(kname: str, tname: str, loc: float = 0.0, scale: float = 1.0,
               device=None):
    """The frozen kernel of the synthetic studies and its adapt state:
    ``rwm`` is ARWMH with step size ``scale``, ``sss`` ASSS at (loc,
    scale)."""
    target = _target_1d(tname)
    if kname == "rwm":
        return frozen_arwmh(target, loc=loc, scale=1.0, step=scale,
                            device=device)
    return frozen_asss(target, loc=loc, scale=scale, device=device)


def quantiles(x: Tensor, qs=QUANTILES) -> Tensor:
    """Per-row quantiles of ``x`` (rows, n) with ``jnp.quantile``'s linear
    interpolation, by one sort (``torch.quantile`` refuses more than 2^24
    elements); returns (len(qs), rows)."""
    s = torch.sort(x, dim=1).values
    n = s.shape[1]
    out = []
    for q in qs:
        pos = torch.tensor(q, dtype=torch.float32) \
            * torch.tensor(n - 1, dtype=torch.float32)
        lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
        w = float(pos - lo)
        out.append(s[:, lo] * (1.0 - w) + s[:, hi] * w)
    return torch.stack(out)


def _band(Px: Tensor) -> dict:
    """Mean and quantile bands per probe of rollouts (n_points, n_samples)."""
    return {"mean": _np(torch.mean(Px, dim=1)), "q": _np(quantiles(Px))}


def _hist(x: Tensor, edges: np.ndarray) -> np.ndarray:
    """Counts of ``x`` in the bins of ``edges`` (the last bin closed), on
    the device of ``x``."""
    e = torch.tensor(edges, dtype=torch.float32, device=x.device)
    idx = torch.bucketize(x.reshape(-1), e, right=True) - 1
    idx = torch.where(x.reshape(-1) == e[-1], len(edges) - 2, idx)
    keep = (idx >= 0) & (idx < len(edges) - 1)
    counts = torch.zeros(len(edges) - 1, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, torch.where(keep, idx, 0),
                        keep.to(torch.int64))
    return _np(counts)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) \
        else np.asarray(x)


def _rho(kc, ac, kb, ab, generator, x, sample_batch_size, n_eval_batches,
         max_steps) -> float:
    rho, _, _ = compute_kernel_distance_1d(
        make_sample_px(kc, ac), make_sample_px(kb, ab), generator, x,
        sample_batch_size=sample_batch_size, n_eval_batches=n_eval_batches,
        max_steps=max_steps)
    return float(rho)


def _stem(kname: str, tname: str, what: str, loc) -> str:
    return f"{kname}-{tname}-{what}" if loc is None \
        else f"{kname}-{tname}-{what}-m{int(loc)}"


def _mtag(loc) -> str:
    return "" if loc is None else rf"\mu={loc:g}, "


# ---------------------------------------------------------------------------
# The families: data on the device, then the drawing.
# ---------------------------------------------------------------------------

INVARIANCE_CASES = (("normal-invariance", "normal"),
                    ("mixture-invariance", "mixture"))
INVARIANCE_EDGES = np.linspace(-3.0, 3.0, 121)


def data_invariance(device="cuda", seed=0, n=200_000) -> dict:
    """One adaptive ARWMH (rwm) and ASSS (sss) step from n exact draws of
    the normal and the mixture: histogram counts of the pushed draws over
    fixed edges on [−3, 3], and the two-sample KS against a fresh exact
    sample beside its null threshold."""
    out = {"edges": INVARIANCE_EDGES, "n": np.asarray(n),
           "ks_threshold": np.asarray(ks_null_threshold(n))}
    for name, tname in INVARIANCE_CASES:
        target = _target_1d(tname)
        for kname, build in (("rwm", arwmh), ("sss", asss)):
            exact = _exact_1d_samples(tname, _gen(device, seed), n)[:, None]
            pushed = push_through_kernel(build(target), _gen(device, seed + 1),
                                         exact, n_steps=1)[:, 0]
            fresh = _exact_1d_samples(tname, _gen(device, seed + 2), n)
            out[f"{kname}-{name}.counts"] = _hist(pushed, INVARIANCE_EDGES)
            out[f"{kname}-{name}.ks"] = _np(ks_statistic(pushed, fresh))
    return out


def _density(tname: str, g: np.ndarray) -> np.ndarray:
    if tname == "normal":
        return np.exp(-0.5 * g**2) / np.sqrt(2 * np.pi)
    return 0.5 * (np.exp(-0.5 * ((g + 1) / 0.1) ** 2)
                  + np.exp(-0.5 * ((g - 1) / 0.1) ** 2)) \
        / (0.1 * np.sqrt(2 * np.pi))


def draw_invariance(data: dict, out_dir: Path) -> None:
    plt = _plt()
    edges, n = data["edges"], float(data["n"])
    grid = np.linspace(-3, 3, 400)
    for name, tname in INVARIANCE_CASES:
        for kname in ("rwm", "sss"):
            counts = data[f"{kname}-{name}.counts"]
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.stairs(counts / (n * np.diff(edges)), edges, fill=True,
                      alpha=0.5, label=f"π P ({kname})")
            ax.plot(grid, _density(tname, grid), "k-", lw=1.5, label="π")
            ax.set_xlim(-3, 3)
            ax.legend()
            ax.set_title(f"Invariance: one {kname} step from exact π")
            _save(fig, out_dir, f"{kname}-{name}")


def data_accept_rate(device="cuda", seed=0, n_iters=3000, n_chains=256
                     ) -> dict:
    """The mean acceptance rate of frozen ARWMH on N(0, 1) after
    ``n_iters`` steps of ``n_chains`` chains, per step size of
    geomspace(0.05, 30, 16)."""
    target = std_normal(1)
    scales = np.geomspace(0.05, 30, 16)
    rates = []
    for s in scales:
        k, adapt = frozen_arwmh(target, step=float(s), device=device)
        adapt = map_state(lambda a: a.expand((n_chains,) + a.shape[1:])
                          .contiguous(), adapt)
        g = _gen(device, seed)
        st = k.init(g, n_chains=n_chains, adapt_state=adapt, device=device)
        st = advancer(k, g, st, MAX_GRAPH_STEPS)(st, n_iters)
        rates.append(float(torch.mean(st.mean_accept_prob)))
    return {"scales": scales, "rates": np.asarray(rates)}


def draw_accept_rate(data: dict, out_dir: Path) -> None:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(data["scales"], data["rates"], "o-")
    ax.axhline(0.234, color="r", ls="--", label="0.234 target")
    ax.set_xlabel("proposal step size")
    ax.set_ylabel("acceptance rate")
    ax.legend()
    _save(fig, out_dir, "accept-rate-vs-scale")


PNX_POINTS, PNX_NS = (-2.0, 0.0, 2.0), (1, 8, 64)
PNX_EDGES = np.linspace(-4.0, 4.0, 81)


def data_pnx(device="cuda", seed=0, n_samples=20_000) -> dict:
    """P^n(x, ·) of frozen ARWMH on N(0, 1) at x ∈ {−2, 0, 2}, n ∈ {1, 8,
    64}: histogram counts over fixed edges on [−4, 4]."""
    k, adapt = frozen_arwmh(std_normal(1), device=device)
    xs = torch.tensor(PNX_POINTS, device=device)[:, None]
    out = {"edges": PNX_EDGES, "n_samples": np.asarray(n_samples)}
    for n in PNX_NS:
        Px = sample_pnx(k, seed, xs, adapt, n=n, n_samples=n_samples)
        out[f"n{n}.counts"] = np.stack([_hist(Px[i, :, 0], PNX_EDGES)
                                        for i in range(len(PNX_POINTS))])
    return out


def draw_pnx(data: dict, out_dir: Path) -> None:
    plt = _plt()
    edges, m = data["edges"], float(data["n_samples"])
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2), sharey=True)
    grid = np.linspace(-4, 4, 300)
    for ax, n in zip(axes, PNX_NS):
        for i, x0 in enumerate(PNX_POINTS):
            ax.stairs(data[f"n{n}.counts"][i] / (m * np.diff(edges)), edges,
                      fill=True, alpha=0.45, label=f"x={x0:g}")
        ax.plot(grid, np.exp(-0.5 * grid**2) / np.sqrt(2 * np.pi), "k-")
        ax.set_title(f"P^{n}(x, ·)")
    axes[0].legend()
    _save(fig, out_dir, "pnx-distributions")


CONTRACTION_NS = (1, 2, 4, 8, 16, 32)


def data_contraction(device="cuda", seed=0, n_samples=5000) -> dict:
    """max_x τ_x(P^n) of frozen ARWMH on N(0, 1) per step size (0.1, 1,
    10), 9 probes on [−2, 2], n ∈ {1, 2, 4, …, 32}."""
    xs = _linspace(-2, 2, 9, device)
    out = {"ns": np.asarray(CONTRACTION_NS)}
    for s in SIGMAS:
        k, adapt = frozen_arwmh(std_normal(1), step=s, device=device)
        out[f"step{s:g}"] = _np(contraction_decay_curve(
            k, _gen(device, seed), xs, adapt, ns=CONTRACTION_NS,
            n_samples=n_samples))
    return out


def draw_contraction(data: dict, out_dir: Path) -> None:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for s in SIGMAS:
        ax.semilogy(data["ns"], data[f"step{s:g}"], "o-", label=f"step={s:g}")
    ax.axhline(1.0, color="k", lw=0.8)
    ax.set_xlabel("n (kernel steps)")
    ax.set_ylabel(r"$\max_x \tau_x(P^n)$")
    ax.legend()
    _save(fig, out_dir, "contraction-decay")


KD_FILES = (
    ("rwm-normal-kernel-dist-scale", KD_SCALES,
     r"kernel distance estimate $\rho(P_{\sigma}, P_{1})$"),
    ("rwm-normal-kernel-dist", tuple(np.geomspace(0.1, 10.0, 9)),
     r"kernel distance $\rho(P_{\sigma}, P_{1})$"),
)


def data_kernel_distance(device="cuda", seed=0, sample_batch_size=2000,
                         n_eval_batches=16, max_steps=40) -> dict:
    """ρ(P_σ, P_1) of frozen ARWMH on N(0, 1), 12 probes on [−2, 2], for
    σ in the scale list and in geomspace(0.1, 10, 9)."""
    x = _linspace(-2, 2, 12, device)
    k1, a1 = frozen_arwmh(std_normal(1), step=1.0, device=device)
    out = {}
    for fname, sigmas, _ in KD_FILES:
        rhos = []
        for s in sigmas:
            k2, a2 = frozen_arwmh(std_normal(1), step=float(s), device=device)
            rhos.append(_rho(k2, a2, k1, a1, _gen(device, seed), x,
                             sample_batch_size, n_eval_batches, max_steps))
        out[f"{fname}.sigmas"] = np.asarray(sigmas)
        out[f"{fname}.rhos"] = np.asarray(rhos)
    return out


def draw_kernel_distance(data: dict, out_dir: Path) -> None:
    plt = _plt()
    for fname, _, ylab in KD_FILES:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(data[f"{fname}.sigmas"], data[f"{fname}.rhos"], ".-")
        ax.semilogx()
        ax.set_xlabel(r"scale $\sigma$, logarithmic")
        ax.set_ylabel(ylab)
        ax.set_ylim(bottom=0)
        _save(fig, out_dir, fname)


DRIFT_DECAYS = ((1.0, "C0"), (2 / 3, "C1"), (0.5, "C2"))


def data_adaptation_drift(device="cuda", seed=0, n_pow=4, n_chains=8
                          ) -> dict:
    """Adaptive ARWMH on centered eight schools (K1 on the card) per
    lr_decay ∈ {1, 2/3, 1/2}: the mean ``as_change`` over the chains on the
    log grid of 10^n_pow steps."""
    target = eight_schools_centered()
    out = {"ns": _np(ns_logscale(n_pow))}
    for decay, _ in DRIFT_DECAYS:
        k = arwmh(target, ARWMHConfig(lr_decay=decay))
        states, _ = collect_states_logscale(k, _gen(device, seed),
                                            n_pow=n_pow, n_chains=n_chains)
        out[f"a{decay:.3g}"] = _np(torch.mean(states.as_change, dim=1))
    return out


def draw_adaptation_drift(data: dict, out_dir: Path) -> None:
    plt = _plt()
    ns = data["ns"]
    fig, ax = plt.subplots(figsize=(6, 4))
    for decay, color in DRIFT_DECAYS:
        ax.loglog(ns, data[f"a{decay:.3g}"], color=color,
                  label=f"a={decay:.3g}")
    ax.loglog(ns, 1.0 / np.sqrt(ns), "k--", lw=0.8, label=r"$n^{-1/2}$")
    ax.set_xlabel("iteration n")
    ax.set_ylabel(r"$\|\Delta(\lambda\Sigma^{1/2})\|_F$")
    ax.legend()
    _save(fig, out_dir, "adaptation-drift")


SSS_X_CONTRACTION = ((0.0, (1, 2, 5), "sss-mixture-x-contraction-m0"),
                     (1.0, (1, 5, 10), "sss-mixture-x-contraction-m1"))


def data_sss_x_contraction(device="cuda", seed=0, n_samples=100_000,
                           n_points=50) -> dict:
    """τ_x(P^n) of frozen ASSS on the mixture per probe of the arctan grid,
    at loc 0 (n = 1, 2, 5) and loc 1 (n = 1, 5, 10)."""
    xs = _arctan_probe_grid(n_points, device=device)
    out = {"xs": _np(xs)}
    for loc, n_list, fname in SSS_X_CONTRACTION:
        k, adapt = frozen_asss(gaussian_mixture_1d(), loc=loc, device=device)
        for i, n in enumerate(n_list):
            out[f"{fname}.n{n}"] = _np(taus_finite_difference_arctan(
                k, seed + i, xs, adapt, n_steps=n, n_samples=n_samples))
    return out


def draw_sss_x_contraction(data: dict, out_dir: Path) -> None:
    plt = _plt()
    for loc, n_list, fname in SSS_X_CONTRACTION:
        fig, ax = plt.subplots(figsize=(6, 4))
        for n in n_list:
            ax.plot(data["xs"], data[f"{fname}.n{n}"], label=f"$n$ = {n}")
        ax.set_title(rf"$\mu = {loc:g}, \sigma = 1$")
        ax.set_xlabel("$x$")
        ax.set_ylabel(r"contraction estimate $\tau_x(P^n)$")
        ax.legend(loc="upper right")
        _save(fig, out_dir, fname)


SSS_DECAY_NS = (1, 5, 10, 20)


def data_sss_contraction(device="cuda", seed=0, n_samples=50_000,
                         n_points=24) -> dict:
    """max_x τ(P_σ^n) of frozen ASSS on the mixture at (loc, σ) ∈ {0, 1} ×
    {0.1, 1, 10}, n ∈ {1, 5, 10, 20}, on the arctan grid."""
    xs = _arctan_probe_grid(n_points, device=device)
    out = {"ns": np.asarray(SSS_DECAY_NS)}
    for loc in (0.0, 1.0):
        for sigma in SIGMAS:
            k, adapt = frozen_asss(gaussian_mixture_1d(), loc=loc,
                                   scale=sigma, device=device)
            out[f"m{int(loc)}.s{sigma:g}"] = _np(contraction_decay_curve(
                k, _gen(device, seed), xs, adapt, ns=SSS_DECAY_NS,
                taus_fn=taus_finite_difference_arctan, n_samples=n_samples))
    return out


def draw_sss_contraction(data: dict, out_dir: Path) -> None:
    plt = _plt()
    ns = data["ns"]
    for loc in (0.0, 1.0):
        fig, ax = plt.subplots(figsize=(6, 4))
        for sigma, color in zip(SIGMAS, SIGMA_COLORS):
            ax.plot(ns, data[f"m{int(loc)}.s{sigma:g}"], ".-", color=color,
                    label=rf"$\mu={loc:g}, \sigma = {sigma:g}$")
        ax.axhline(1.0, ls="--", color="gray")
        ax.set_xticks(ns)
        ax.set_xlabel("power $n$")
        ax.set_ylabel(r"contraction estimate $\tau(P_\sigma^n)$")
        ax.legend(loc="upper right")
        _save(fig, out_dir, f"sss-mixture-contraction-decrease-m{int(loc)}")


def data_sss_kernel_distance(device="cuda", seed=0, sample_batch_size=2000,
                             n_eval_batches=16, max_steps=40) -> dict:
    """ρ(P_σ, P_1) of frozen ASSS on N(0, 1) as the adapt-state scale
    moves, 12 probes on [−2, 2]."""
    x = _linspace(-2, 2, 12, device)
    k1, a1 = frozen_asss(std_normal(1), scale=1.0, device=device)
    rhos = []
    for s in KD_SCALES:
        k2, a2 = frozen_asss(std_normal(1), scale=float(s), device=device)
        rhos.append(_rho(k2, a2, k1, a1, _gen(device, seed), x,
                         sample_batch_size, n_eval_batches, max_steps))
    return {"sigmas": np.asarray(KD_SCALES), "rhos": np.asarray(rhos)}


def draw_sss_kernel_distance(data: dict, out_dir: Path) -> None:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(data["sigmas"], data["rhos"], "o-")
    ax.set_xlabel(r"adapt-state scale $\sigma$")
    ax.set_ylabel(r"$\rho(P_\sigma, P_1)$ (ASSS)")
    _save(fig, out_dir, "sss-normal-kernel-dist-scale")


X_STEP_CASES = (("rwm", (None,), (1, 2, 5, 10, 20, 50)),
                ("sss", (0.0, 1.0), (1, 2, 5)))


def _x_step_stem(kname, tname, loc, n) -> str:
    return f"{kname}-{tname}-x-step-s1-n{n}" if loc is None \
        else f"{kname}-{tname}-x-step-m{int(loc)}-s1-n{n}"


def data_x_step(device="cuda", seed=0, n_samples=50_000, n_points=100
                ) -> dict:
    """E[x_next] and the 5/25/75/95% bands of P^n(x, ·) per probe of
    linspace(−5, 5, 100): frozen ARWMH (n = 1, 2, 5, 10, 20, 50) and
    frozen ASSS at loc 0 and 1 (n = 1, 2, 5), on both targets."""
    xs = _linspace(-5, 5, n_points, device)
    out = {"xs": _np(xs), "n_samples": np.asarray(n_samples)}
    for tname in ("normal", "mixture"):
        for kname, locs, ns in X_STEP_CASES:
            for loc in locs:
                k, adapt = _frozen_1d(kname, tname, loc=loc or 0.0,
                                      device=device)
                for n in ns:
                    Px = sample_pnx(k, seed, xs[:, None], adapt, n=n,
                                    n_samples=n_samples)[:, :, 0]
                    stem = _x_step_stem(kname, tname, loc, n)
                    for key, v in _band(Px).items():
                        out[f"{stem}.{key}"] = v
    return out


def _draw_band(ax, x, mean, q) -> None:
    ax.plot(x, mean, color="blue", label="$E[x_{next}]$")
    ax.fill_between(x, q[1], q[2], alpha=0.5, color="blue", label="50% CI")
    ax.fill_between(x, q[0], q[3], alpha=0.3, color="blue", label="90% CI")
    ax.plot(x, x, "--", color="gray", label=r"$x = x_{next}$")


def draw_x_step(data: dict, out_dir: Path) -> None:
    plt = _plt()
    x = data["xs"]
    for tname in ("normal", "mixture"):
        for kname, locs, ns in X_STEP_CASES:
            for loc in locs:
                for n in ns:
                    stem = _x_step_stem(kname, tname, loc, n)
                    fig, ax = plt.subplots(figsize=(5, 5))
                    ax.set_title(rf"${_mtag(loc)}\sigma=1, n={n}$")
                    _draw_band(ax, x, data[f"{stem}.mean"],
                               data[f"{stem}.q"])
                    ax.set_xlabel("$x$")
                    ax.legend(loc="upper left")
                    _save(fig, out_dir, stem)


GRID_TARGETS = (("normal", 5.0, (0.0,)), ("mixture", 2.5, (-1.0, 1.0)))
GRID_RWM_NS, GRID_SSS = (1, 5, 10, 50), ((0.0, (1, 2)), (1.0, (1, 2)))


def data_x_step_grids(device="cuda", seed=0, n_samples=100_000,
                      n_points=100) -> dict:
    """The 2×2 step-distribution panels: per target (normal on [−5, 5],
    the mixture on [−2.5, 2.5], 100 probes) frozen ARWMH at n ∈ {1, 5, 10,
    50} and frozen ASSS at (loc, n) ∈ {0, 1} × {1, 2}: mean and bands per
    probe over (100, 100000) rollouts."""
    out = {}
    for tname, lim, _ in GRID_TARGETS:
        xs = _linspace(-lim, lim, n_points, device)
        out[f"{tname}.xs"] = _np(xs)
        panels = [("rwm", None, n) for n in GRID_RWM_NS] + \
            [("sss", loc, n) for loc, ns in GRID_SSS for n in ns]
        kernels = {}
        for kname, loc, n in panels:
            if (kname, loc) not in kernels:
                kernels[(kname, loc)] = _frozen_1d(kname, tname,
                                                   loc=loc or 0.0,
                                                   device=device)
            k, adapt = kernels[(kname, loc)]
            Px = sample_pnx(k, seed, xs[:, None], adapt, n=n,
                            n_samples=n_samples)[:, :, 0]
            tag = f"{tname}.{kname}" + ("" if loc is None
                                        else f".m{int(loc)}") + f".n{n}"
            for key, v in _band(Px).items():
                out[f"{tag}.{key}"] = v
            del Px
    return out


def draw_x_step_grids(data: dict, out_dir: Path) -> None:
    plt = _plt()

    def panel(ax, tag, x, title, modes, lim):
        ax.set_title(title)
        _draw_band(ax, x, data[f"{tag}.mean"], data[f"{tag}.q"])
        ax.vlines(modes, -lim, lim, linestyles="--", color="green",
                  label=r"mode(s) of target $\pi$")
        ax.set_xlabel("$x$")
        ax.set_ylabel("$x_{next}$")

    for tname, lim, modes in GRID_TARGETS:
        x = data[f"{tname}.xs"]
        fig, axs = plt.subplots(2, 2, figsize=(10, 10))
        for n, ax in zip(GRID_RWM_NS, axs.flatten()):
            panel(ax, f"{tname}.rwm.n{n}", x, rf"$\sigma=1, n={n}$",
                  list(modes), lim)
        axs[1, 1].legend(loc="lower right")
        _save(fig, out_dir, f"rwm-{tname}-x-step-s1")
        fig, axs = plt.subplots(2, 2, figsize=(10, 10))
        for (loc, ns), row in zip(GRID_SSS, axs):
            for n, ax in zip(ns, row):
                panel(ax, f"{tname}.sss.m{int(loc)}.n{n}", x,
                      rf"$\mu={int(loc)}, \sigma=1, n={n}$", list(modes),
                      lim)
        axs[1, 1].legend(loc="lower right")
        _save(fig, out_dir, f"sss-{tname}-x-step-m01-s1")


W_CASES = (("rwm", (None,)), ("sss", (0.0, 1.0)))


def data_x_wasserstein(device="cuda", seed=0, n_samples=50_000,
                       n_points=100) -> dict:
    """W_1(P(x, ·), π) per probe of linspace(−5, 5, 100) and adapt scale σ
    ∈ {0.1, 1, 10} (frozen ARWMH; frozen ASSS at loc 0 and 1), with the
    eccentricity E|π − x|, on both targets."""
    xs = _linspace(-5, 5, n_points, device)
    out = {"xs": _np(xs)}
    for tname in ("normal", "mixture"):
        pi = _exact_1d_samples(tname, _gen(device, seed + 42), n_samples)
        out[f"{tname}.ecc"] = _np(torch.mean(
            torch.abs(pi[None, :] - xs[:, None]), dim=1))
        for kname, locs in W_CASES:
            for loc in locs:
                stem = _stem(kname, tname, "x-wasserstein", loc)
                for sigma in SIGMAS:
                    k, adapt = _frozen_1d(kname, tname, loc=loc or 0.0,
                                          scale=sigma, device=device)
                    Px = sample_pnx(k, seed, xs[:, None], adapt, n=1,
                                    n_samples=n_samples)[:, :, 0]
                    out[f"{stem}.s{sigma:g}"] = _np(wasserstein_1d(Px, pi))
    return out


def draw_x_wasserstein(data: dict, out_dir: Path) -> None:
    plt = _plt()
    x = data["xs"]
    for tname in ("normal", "mixture"):
        for kname, locs in W_CASES:
            for loc in locs:
                stem = _stem(kname, tname, "x-wasserstein", loc)
                fig, ax = plt.subplots(figsize=(6, 4))
                ax.plot(x, data[f"{tname}.ecc"], "--", color="gray",
                        label="eccentricity")
                for sigma, color in zip(SIGMAS, SIGMA_COLORS):
                    ax.plot(x, data[f"{stem}.s{sigma:g}"], color=color,
                            label=rf"${_mtag(loc)}\sigma = {sigma:g}$")
                ax.set_xlabel("$x$")
                ax.set_ylabel(r"$\mathcal{W}(\delta_x P_{\mu,\sigma}, \pi)$")
                ax.legend(loc="center right")
                _save(fig, out_dir, stem)


X_CONTRACTION_CASES = (("rwm", "normal", None, (1, 2, 5)),
                       ("rwm", "mixture", None, (1, 2, 5)),
                       ("sss", "normal", 0.0, (1, 2)),
                       ("sss", "normal", 1.0, (1, 5, 10)))


def data_x_contraction(device="cuda", seed=0, n_samples=50_000,
                       n_points=50) -> dict:
    """τ_x(P^n) per probe for frozen ARWMH on both targets (additive pairs,
    linspace(−2.5, 2.5, 50)) and frozen ASSS on N(0, 1) at loc 0 and 1
    (the arctan grid)."""
    out = {}
    for kname, tname, loc, ns in X_CONTRACTION_CASES:
        xs = _linspace(-2.5, 2.5, n_points, device) if kname == "rwm" \
            else _arctan_probe_grid(n_points, device=device)
        k, adapt = _frozen_1d(kname, tname, loc=loc or 0.0, device=device)
        taus_fn = taus_finite_difference if kname == "rwm" \
            else taus_finite_difference_arctan
        stem = _stem(kname, tname, "x-contraction", loc)
        out[f"{stem}.xs"] = _np(xs)
        for i, n in enumerate(ns):
            out[f"{stem}.n{n}"] = _np(taus_fn(k, seed + i, xs, adapt,
                                              n_steps=n, n_samples=n_samples))
    return out


def draw_x_contraction(data: dict, out_dir: Path) -> None:
    plt = _plt()
    for kname, tname, loc, ns in X_CONTRACTION_CASES:
        stem = _stem(kname, tname, "x-contraction", loc)
        fig, ax = plt.subplots(figsize=(6, 4))
        for n in ns:
            ax.plot(data[f"{stem}.xs"], data[f"{stem}.n{n}"],
                    label=f"$n$ = {n}")
        if loc is not None:
            ax.set_title(rf"$\mu = {loc:g}, \sigma = 1$")
        ax.set_xlabel("$x$")
        ax.set_ylabel(r"contraction estimate $\tau_x(P^n)$")
        ax.legend(loc="upper right")
        _save(fig, out_dir, stem)


DECREASE_CASES = (("rwm", "normal", None), ("rwm", "mixture", None),
                  ("sss", "normal", 0.0), ("sss", "normal", 1.0))


def _decrease_ns(kname: str) -> tuple:
    return (1, 2, 3, 4, 5) if kname == "rwm" else SSS_DECAY_NS


def data_contraction_decrease(device="cuda", seed=0, n_samples=30_000,
                              n_points=24) -> dict:
    """max_x τ(P^n) per adapt scale σ ∈ {0.1, 1, 10} for frozen ARWMH on
    both targets (n = 1…5) and frozen ASSS on N(0, 1) at loc 0 and 1 (n =
    1, 5, 10, 20)."""
    out = {}
    for kname, tname, loc in DECREASE_CASES:
        xs = _linspace(-2.5, 2.5, n_points, device) if kname == "rwm" \
            else _arctan_probe_grid(n_points, device=device)
        taus_fn = taus_finite_difference if kname == "rwm" \
            else taus_finite_difference_arctan
        stem = _stem(kname, tname, "contraction-decrease", loc)
        for sigma in SIGMAS:
            k, adapt = _frozen_1d(kname, tname, loc=loc or 0.0, scale=sigma,
                                  device=device)
            out[f"{stem}.s{sigma:g}"] = _np(contraction_decay_curve(
                k, _gen(device, seed), xs, adapt, ns=_decrease_ns(kname),
                taus_fn=taus_fn, n_samples=n_samples))
    return out


def draw_contraction_decrease(data: dict, out_dir: Path) -> None:
    plt = _plt()
    for kname, tname, loc in DECREASE_CASES:
        ns = _decrease_ns(kname)
        stem = _stem(kname, tname, "contraction-decrease", loc)
        fig, ax = plt.subplots(figsize=(6, 4))
        for sigma, color in zip(SIGMAS, SIGMA_COLORS):
            ax.plot(ns, data[f"{stem}.s{sigma:g}"], ".-", color=color,
                    label=rf"${_mtag(loc)}\sigma = {sigma:g}$")
        ax.axhline(1.0, ls="--", color="gray")
        ax.set_xticks(ns)
        ax.set_xlabel("power $n$")
        ax.set_ylabel(r"contraction estimate $\tau(P_{\mu,\sigma}^n)$")
        ax.legend(loc="upper right")
        _save(fig, out_dir, stem)


KD_LOCS = tuple(np.linspace(0.0, 2.0, 9))


def data_kernel_dist_families(device="cuda", seed=0, sample_batch_size=2000,
                              n_eval_batches=16, max_steps=40) -> dict:
    """ρ(P_{1,σ}, P_{1,1}) of frozen ASSS on N(0, 1) over the scale list,
    and ρ(P_{μ,1}, P_{0,1}) over loc ∈ linspace(0, 2, 9)."""
    x = _linspace(-2, 2, 12, device)

    def curve(base, comps):
        kb, ab = _frozen_1d("sss", "normal", **base, device=device)
        return np.asarray([
            _rho(*_frozen_1d("sss", "normal", **c, device=device), kb, ab,
                 _gen(device, seed), x, sample_batch_size, n_eval_batches,
                 max_steps) for c in comps])

    return {"scales": np.asarray(KD_SCALES),
            "scale_rhos": curve(dict(loc=1.0, scale=1.0),
                                [dict(loc=1.0, scale=float(s))
                                 for s in KD_SCALES]),
            "locs": np.asarray(KD_LOCS),
            "loc_rhos": curve(dict(loc=0.0, scale=1.0),
                              [dict(loc=float(m), scale=1.0)
                               for m in KD_LOCS])}


def draw_kernel_dist_families(data: dict, out_dir: Path) -> None:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogx(data["scales"], data["scale_rhos"], ".-")
    ax.set_title(r"$\mu=1$")
    ax.set_xlabel(r"scale $\sigma$, logarithmic")
    ax.set_ylabel(r"kernel distance estimate $\rho(P_{1,\sigma}, P_{1,1})$")
    _save(fig, out_dir, "sss-normal-kernel-dist-scale-m1")
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(data["locs"], data["loc_rhos"], ".-")
    ax.set_title(r"$\sigma=1$")
    ax.set_xlabel(r"location $\mu$")
    ax.set_ylabel(r"kernel distance estimate $\rho(P_{\mu,1}, P_{0,1})$")
    _save(fig, out_dir, "sss-normal-kernel-dist-loc")


DUAL_STEPS = (0, 5, 10, 100)
DUAL_COLORS = ("royalblue", "blue", "mediumblue", "midnightblue")
DUAL_CASES = (("rwm", "normal", None), ("rwm", "mixture", None),
              ("sss", "normal", 0.0), ("sss", "normal", 1.0),
              ("sss", "mixture", 0.0), ("sss", "mixture", 1.0))


def data_contraction_dual(device="cuda", seed=0, steps=DUAL_STEPS,
                          n_points=100, sample_batch_size=1000,
                          n_train_batches=8, n_pf_samples=20_000) -> dict:
    """f(x) and Pf(x) on linspace(−2.5, 2.5, 100) of the Lipschitz MLP
    trained for each budget of ``steps`` (8 batches of 1000 samples), for
    frozen ARWMH on both targets and frozen ASSS at loc 0 and 1 on both."""
    xs = _linspace(-2.5, 2.5, n_points, device)
    X = xs[:, None]
    out = {"xs": _np(xs), "steps": np.asarray(steps)}
    for kname, tname, loc in DUAL_CASES:
        k, adapt = _frozen_1d(kname, tname, loc=loc or 0.0, device=device)
        sample_px = make_sample_px(k, adapt)
        stem = _stem(kname, tname, "contraction-dual", loc)
        for step in steps:
            _, _, params = compute_wasserstein_contraction(
                sample_px, _gen(device, seed), X,
                sample_batch_size=sample_batch_size,
                n_train_batches=n_train_batches, n_eval_batches=1,
                max_steps=step)
            with torch.no_grad():
                out[f"{stem}.f{step}"] = _np(apply_lipschitz_mlp(params, X))
                samp = sample_px(seed + 1, X, n_pf_samples)
                out[f"{stem}.pf{step}"] = _np(torch.mean(
                    apply_lipschitz_mlp(params, samp), dim=1))
    return out


def draw_contraction_dual(data: dict, out_dir: Path) -> None:
    plt = _plt()
    x = data["xs"]
    for kname, tname, loc in DUAL_CASES:
        stem = _stem(kname, tname, "contraction-dual", loc)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12.8, 4.8),
                                       sharey=True)
        for step, color in zip(data["steps"], DUAL_COLORS):
            ax1.plot(x, data[f"{stem}.f{step}"], color=color,
                     label=f"steps={step}")
            ax2.plot(x, data[f"{stem}.pf{step}"], color=color,
                     label=f"steps={step}")
        if loc is not None:
            fig.suptitle(rf"$\mu={loc:g}, \sigma=1$")
        ax1.set_ylabel("f(x)")
        ax2.set_ylabel("Pf(x)")
        ax1.set_xlabel("x")
        ax2.set_xlabel("x")
        ax1.legend(loc="lower right")
        _save(fig, out_dir, stem)


# ---------------------------------------------------------------------------
# The registry and the command line.
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_dir: Path, stem: str) -> None:
    import matplotlib.pyplot as plt

    fig.savefig(Path(out_dir) / f"{stem}.svg", bbox_inches="tight")
    plt.close(fig)


ALL_FIGURES = {
    name: (globals()[f"data_{name}"], globals()[f"draw_{name}"])
    for name in ("invariance", "accept_rate", "pnx", "contraction",
                 "kernel_distance", "adaptation_drift", "sss_x_contraction",
                 "sss_contraction", "sss_kernel_distance", "x_step",
                 "x_step_grids", "x_wasserstein", "x_contraction",
                 "contraction_decrease", "kernel_dist_families",
                 "contraction_dual")
}


def theory_gates(data: dict) -> list:
    """The checks the theory fixes, on ``data`` ({family: its data}) for
    the families present: (name, value, limit, held) per check.

    * accept_rate: the rate falls with the step size (never rises) and
      crosses 0.234;
    * invariance: each kernel's KS after one step from π under 1.5× the
      null threshold;
    * x_contraction: frozen ASSS's τ_x(P) on N(0, 1) at or below 1 within
      three Monte-Carlo sds, the sd estimated from the probe-to-probe
      differences (std(Δτ) / √2: the curve is smooth, the noise is not);
    * x_step: on N(0, 1) the mean over the probes of |E[x_next]| falls
      with n until it is within three standard errors of 0."""
    out = []
    if "accept_rate" in data:
        r = data["accept_rate"]["rates"]
        out.append(("accept_rate falls with the step size",
                    float(np.max(np.diff(r))), 0.0,
                    bool(np.all(np.diff(r) <= 0.0))))
        out.append(("accept_rate crosses 0.234",
                    float(r[0]), float(r[-1]), bool(r[0] > 0.234 > r[-1])))
    if "invariance" in data:
        d = data["invariance"]
        lim = 1.5 * float(d["ks_threshold"])
        for key in sorted(k for k in d if k.endswith(".ks")):
            out.append((f"invariance KS {key[:-3]}", float(d[key]), lim,
                        float(d[key]) < lim))
    if "x_contraction" in data:
        tau = data["x_contraction"]["sss-normal-x-contraction-m0.n1"]
        mc = float(np.std(np.diff(tau)) / np.sqrt(2.0))
        out.append(("frozen ASSS max_x tau_x(P) on N(0, 1)",
                    float(np.max(tau)), 1.0 + 3.0 * mc,
                    float(np.max(tau)) <= 1.0 + 3.0 * mc))
    if "x_step" in data:
        d = data["x_step"]
        for kname, loc, ns in (("rwm", None, X_STEP_CASES[0][2]),
                               ("sss", 0.0, X_STEP_CASES[1][2])):
            stems = [_x_step_stem(kname, "normal", loc, n) for n in ns]
            m = [float(np.mean(np.abs(d[f"{s}.mean"]))) for s in stems]
            # the sd of P^n(x, ·) from its 90% band, over the probes
            sd = [float(np.mean(d[f"{s}.q"][3] - d[f"{s}.q"][0])) / 3.29
                  for s in stems]
            se = [v / np.sqrt(float(d["n_samples"])) for v in sd]
            held = all(m[k + 1] < m[k] or m[k + 1] < 3.0 * se[k + 1]
                       for k in range(len(m) - 1))
            out.append((f"{stems[0][:-3]}: mean |E[x_next]| by n", m[-1],
                        m[0], held))
    return out


def save_data(data: dict, path: Path) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in data.items()})


def load_data(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def main(out_dir=OUT_DIR, only=None, device="cuda", data_only=False,
         from_data=None) -> dict:
    """Every family of :data:`ALL_FIGURES` (or those in ``only``): its data
    on ``device``, then its figure into ``out_dir``.  ``data_only`` writes
    ``<family>.npz`` into ``out_dir`` and draws nothing; ``from_data``
    draws from such files.  Returns the seconds of each family."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    seconds = {}
    for name, (data_fn, draw_fn) in ALL_FIGURES.items():
        if only and name not in only:
            continue
        print(f"[fig] {name} ...", flush=True)
        t0 = time.perf_counter()
        if from_data is not None:
            data = load_data(Path(from_data) / f"{name}.npz")
        else:
            data = data_fn(device=device)
            if data_only:
                save_data(data, out / f"{name}.npz")
        if not data_only:
            draw_fn(data, out)
        seconds[name] = time.perf_counter() - t0
    print(f"figures written to {out}/")
    return seconds


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="The figure families of adaptive_mcmc_tpu_torch.")
    p.add_argument("out_dir", nargs="?", default=str(OUT_DIR))
    p.add_argument("only", nargs="*", help="families (default: all)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-only", action="store_true",
                   help="write <family>.npz and draw nothing")
    p.add_argument("--from-data", default=None,
                   help="draw from the <family>.npz files of this directory")
    return p


if __name__ == "__main__":
    a = _parser().parse_args()
    unknown = set(a.only) - set(ALL_FIGURES)
    if unknown:
        raise SystemExit(f"unknown families: {sorted(unknown)}")
    main(a.out_dir, set(a.only) or None, a.device, a.data_only, a.from_data)
