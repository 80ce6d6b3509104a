"""Convergence diagnostics: split-R̂, effective sample size, summaries
(PyTorch).

Counterpart of ``adaptive_mcmc_tpu/infer/diagnostics.py``: every statistic
is computed for all parameters at once over (draws, chains, ...params)
tensors, with FFT autocovariances.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def split_chains(x: Tensor) -> Tensor:
    """(draws, chains, ...) -> (draws//2, 2*chains, ...)."""
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[h:2 * h]], dim=1)


def gelman_rubin(x: Tensor, *, split: bool = True) -> Tensor:
    """Split-R̂ over (draws, chains, ...params); returns (...params)."""
    if split:
        x = split_chains(x)
    n = x.shape[0]
    chain_mean = torch.mean(x, dim=0)
    chain_var = torch.var(x, dim=0, correction=1)
    w = torch.mean(chain_var, dim=0)
    b = n * torch.var(chain_mean, dim=0, correction=1)
    var_hat = (n - 1) / n * w + b / n
    return torch.sqrt(var_hat / w)


def _autocov_fft(x: Tensor) -> Tensor:
    """Autocovariance along dim 0 via FFT; x: (draws, ...)."""
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    size = 2 * n  # zero-padded circular -> linear correlation
    f = torch.fft.rfft(xc, n=size, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=0)[:n]
    return acov / n


def effective_sample_size(x: Tensor) -> Tensor:
    """ESS over (draws, chains, ...params) by Geyer's initial monotone
    positive sequence on the chain-averaged autocorrelation."""
    n, m = x.shape[0], x.shape[1]
    acov = _autocov_fft(x)                          # (n, chains, ...)
    chain_var = acov[0] * n / (n - 1.0)             # (chains, ...)
    mean_var = torch.mean(chain_var, dim=0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(torch.mean(x, dim=0), dim=0,
                                        correction=1)

    rho = 1.0 - (mean_var - torch.mean(acov, dim=1)) / var_plus  # (n, ...)
    rho[0] = 1.0

    # Geyer pair sums: P_t = rho_{2t} + rho_{2t+1}
    t_max = n // 2
    p = rho[0:2 * t_max:2] + rho[1:2 * t_max:2]     # (t_max, ...)
    # initial positive sequence: stop at the first negative pair sum
    pos_mask = torch.cumprod((p > 0.0).to(p.dtype), dim=0)
    # initial monotone: running minimum
    p_mono = torch.cummin(p, dim=0).values
    tau = -1.0 + 2.0 * torch.sum(p_mono * pos_mask, dim=0)
    return m * n / torch.clamp(tau, min=1e-6)


def _quantile(x: Tensor, q: float) -> Tensor:
    """Linear-interpolation quantile along dim 0 (numpy's default), by a
    sort, with no limit on the input size."""
    s = torch.sort(x, dim=0).values
    pos = q * (s.shape[0] - 1)
    lo = int(pos)
    hi = min(lo + 1, s.shape[0] - 1)
    frac = pos - lo
    return s[lo] + frac * (s[hi] - s[lo])


def summarize(x: Tensor) -> dict:
    """Per-parameter summary over (draws, chains, ...params)."""
    flatd = x.reshape((-1,) + tuple(x.shape[2:]))
    return {
        "mean": torch.mean(flatd, dim=0),
        "std": torch.std(flatd, dim=0, correction=1),
        "median": _quantile(flatd, 0.5),
        "5.0%": _quantile(flatd, 0.05),
        "95.0%": _quantile(flatd, 0.95),
        "n_eff": effective_sample_size(x),
        "r_hat": gelman_rubin(x),
    }


def summary_table(target, samples_unconstrained: Tensor) -> str:
    """Human-readable summary like NumPyro's print_summary, from
    (draws, chains, dim) unconstrained samples, in constrained space per
    site."""
    sites = target.constrain(samples_unconstrained)  # dict of (T, C, ...)
    rows, header = [], (
        f"{'':>16} {'mean':>9} {'std':>9} {'median':>9} {'5.0%':>9} "
        f"{'95.0%':>9} {'n_eff':>9} {'r_hat':>7}"
    )
    for name, v in sites.items():
        v2 = v if v.dim() > 2 else v[..., None]
        stats = {k: s.cpu() for k, s in summarize(v2).items()}
        for idx in range(v2.shape[-1]):
            label = name if v2.shape[-1] == 1 else f"{name}[{idx}]"
            rows.append(
                f"{label:>16} {float(stats['mean'][idx]):>9.2f} "
                f"{float(stats['std'][idx]):>9.2f} "
                f"{float(stats['median'][idx]):>9.2f} "
                f"{float(stats['5.0%'][idx]):>9.2f} "
                f"{float(stats['95.0%'][idx]):>9.2f} "
                f"{float(stats['n_eff'][idx]):>9.0f} "
                f"{float(stats['r_hat'][idx]):>7.2f}"
            )
    return "\n".join([header] + rows)
