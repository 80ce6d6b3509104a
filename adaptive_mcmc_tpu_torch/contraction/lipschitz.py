"""Lipschitz-NN estimators of Wasserstein contraction coefficients and
kernel distances (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/contraction/lipschitz.py``.  Estimates
τ(P) = sup_{x≠y} W(P(x,·), P(y,·)) / d(x, y) and the kernel distance
ρ(P, Q) by training a test function f, a spectrally normalised MLP (so
1-Lipschitz), to maximise |Pf(x_i) − Pf(x_j)| / d(x_i, x_j) over probe
pairs, with Pf a Monte-Carlo mean through the transition kernel.

The same semantics: the quantile-band pair mask, the −logsumexp smooth-max
loss, each gradient clipped elementwise to ±1 before Adam (``optax.adam``'s
arithmetic, written out), a stop at ``max_steps`` or where the squared norm
of the clipped gradient is ≤ 1e-10, and the final hard max of the ratios
over the masked pairs.  Samples are drawn without gradient; the gradient
flows through the MLP only.

A ``sample_px(seed, X, n_samples) -> (n_points, n_samples, d)`` callable
draws from the kernel at every probe point (:func:`make_sample_px` builds
one from a kernel).  The estimators hand it int seeds drawn from their
generator: P and Q get the same seed where they share random numbers, as
JAX's callers pass one key to both.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

Tensor = torch.Tensor
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------------------
# The spectrally normalised MLP.
# ---------------------------------------------------------------------------

def spectral_norm(w: Tensor, num_iters: int = 10, eps: float = 1e-10
                  ) -> Tensor:
    """``w`` divided by max(σ_max, 1) (shrink only), σ_max by power
    iteration from a fixed start vector on every call, with autograd through
    the iterations.  Not ``torch.nn.utils.parametrizations.spectral_norm``,
    which always divides, keeps a random persistent vector and runs one
    iteration per call."""
    u = torch.ones((w.shape[0],), device=w.device) / math.sqrt(w.shape[0])
    v = torch.zeros((w.shape[1],), device=w.device)
    for _ in range(num_iters):
        v = w.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ (w @ v)
    return w / torch.clamp_min(sigma, 1.0)


class LipschitzMLP(nn.Module):
    """f: (..., dim) -> (...): two hidden leaky-ReLU layers (slope 0.01, so
    1-Lipschitz), every weight spectrally normalised.  Weights are kept in
    JAX's (in, out) layout, so that ``h @ W`` is the same product."""

    def __init__(self, dim: int, num_features: int = 32,
                 generator: Optional[torch.Generator] = None, device=None):
        """Weights drawn from ``generator`` (lecun-normal style, as
        ``init_lipschitz_mlp``) and moved to ``device``, or zeros on
        ``device`` without a generator; biases zero."""
        super().__init__()
        sizes = [(dim, num_features), (num_features, num_features),
                 (num_features, 1)]
        ws, bs = [], []
        for fan_in, fan_out in sizes:
            if generator is None:
                w = torch.zeros((fan_in, fan_out), device=device)
            else:
                w = torch.randn((fan_in, fan_out), generator=generator,
                                device=generator.device) \
                    * math.sqrt(1.0 / fan_in)
                w = w.to(device or generator.device)
            ws.append(nn.Parameter(w))
            bs.append(nn.Parameter(torch.zeros((fan_out,), device=w.device)))
        self.weights = nn.ParameterList(ws)
        self.biases = nn.ParameterList(bs)

    def normalized(self) -> list:
        """The spectrally normalised weights, with autograd."""
        return [spectral_norm(w) for w in self.weights]

    def forward(self, x: Tensor, weights: Optional[list] = None) -> Tensor:
        """f(x); ``weights`` are the normalised weights where the caller
        computed them once for several batches (the power iterations are
        some 180 small kernels per call)."""
        h = x
        weights = self.normalized() if weights is None else weights
        last = len(weights) - 1
        for i, (w, b) in enumerate(zip(weights, self.biases)):
            h = h @ w + b
            if i < last:
                h = nn.functional.leaky_relu(h, 0.01)
        return h[..., 0]


def init_lipschitz_mlp(generator: torch.Generator, dim: int,
                       num_features: int = 32, device=None) -> LipschitzMLP:
    """A fresh MLP, its weights drawn from ``generator``, on ``device``
    (the generator's by default)."""
    return LipschitzMLP(dim, num_features, generator, device)


def apply_lipschitz_mlp(params: LipschitzMLP, x: Tensor) -> Tensor:
    """f(x) for (..., dim) inputs: the JAX package's functional form."""
    return params(x)


# ---------------------------------------------------------------------------
# Shared estimation machinery.
# ---------------------------------------------------------------------------

def _quantile_linear(values: Tensor, q: float) -> Tensor:
    """``jnp.quantile(values, q)`` (linear interpolation) in its float32
    arithmetic: the index q (N - 1), its floor and ceiling, and
    low (1 - w) + high w."""
    flat = torch.sort(values.reshape(-1)).values
    n = flat.numel()
    pos = torch.tensor(q, dtype=torch.float32) \
        * torch.tensor(n - 1, dtype=torch.float32)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    low = flat[int(lo.clamp(0, n - 1))]
    high = flat[int(hi.clamp(0, n - 1))]
    return low * w_lo.to(flat.device) + high * w_hi.to(flat.device)


def _pair_mask(X: Tensor, threshold: float = 1e-10):
    """Quantile-band mask over probe-pair distances: keep the pairs with
    d(x_i, x_j) in [2 q_{2d/n}(d), √d · lower + threshold]."""
    n_points, dim = X.shape
    diff = X[:, None] - X[None, :]
    dists = torch.sqrt(torch.sum(diff * diff, dim=-1))
    quantile = 2.0 * dim / n_points
    lower = torch.clamp_min(2.0 * _quantile_linear(dists, quantile),
                            threshold)
    upper = math.sqrt(float(dim)) * lower + threshold
    mask = (lower <= dists) & (dists <= upper)
    return dists, mask


def _seeds(generator: torch.Generator, k: int) -> list:
    """``k`` int seeds for ``sample_px`` calls, drawn from ``generator``."""
    return torch.randint(0, 2**62, (k,), generator=generator,
                         device=generator.device).tolist()


def _adam_train(params: LipschitzMLP, loss_fn: Callable[[], Tensor],
                max_steps: int, lr: float, threshold: float) -> LipschitzMLP:
    """Minimise ``loss_fn()`` (a fresh Monte-Carlo loss per call) over the
    MLP's parameters: each gradient clipped to ±1, then ``optax.adam(lr)``;
    stops after ``max_steps`` or once the squared norm of the clipped
    gradient is ≤ ``threshold``."""
    ps = list(params.parameters())
    mu = [torch.zeros_like(p) for p in ps]
    nu = [torch.zeros_like(p) for p in ps]
    b1 = torch.tensor(ADAM_B1)
    b2 = torch.tensor(ADAM_B2)
    for count in range(1, max_steps + 1):
        grads = torch.autograd.grad(loss_fn(), ps)
        grads = [torch.clamp(g, -1.0, 1.0) for g in grads]
        bc1 = (1.0 - b1**count).to(ps[0].device)
        bc2 = (1.0 - b2**count).to(ps[0].device)
        with torch.no_grad():
            for p, g, m, v in zip(ps, grads, mu, nu):
                m.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * m)
                v.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v)
                update = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
                p.add_(-lr * update)
        gsq = sum(torch.sum(g * g) for g in grads)
        if float(gsq) <= threshold:
            break
    return params


def _train_test_fn(mean_fn: Callable[[LipschitzMLP, list], Tensor],
                   n_seeds: int, generator: torch.Generator, X: Tensor,
                   dists: Tensor, mask: Tensor, *, alpha: float,
                   max_steps: int, lr: float, num_features: int,
                   init_params: Optional[LipschitzMLP],
                   threshold: float = 1e-10) -> LipschitzMLP:
    """Maximise the smooth max of the masked |Δ mean_fn| / d over the
    probe pairs; returns the trained MLP.  ``mean_fn(params, seeds)`` is
    the Monte-Carlo estimate of Pf (or Pf − Qf) at every probe point from
    ``n_seeds`` fresh seeds."""
    params = (init_lipschitz_mlp(generator, X.shape[1], num_features,
                                 X.device)
              if init_params is None else init_params)
    safe_dists = torch.where(mask, dists, 1.0)

    def loss():
        pf = mean_fn(params, _seeds(generator, n_seeds))
        diffs = torch.abs(pf[:, None] - pf[None, :])
        ratios = torch.where(mask, diffs / safe_dists, 0.0)
        return -torch.logsumexp((alpha * ratios).reshape(-1), 0) / alpha

    return _adam_train(params, loss, max_steps, lr, threshold)


def _batch_mean(f: Callable, batch: Tensor) -> Tensor:
    return torch.mean(f(batch), dim=-1)


def _mean_over(batch_fn, params: LipschitzMLP, seeds) -> Tensor:
    """The mean of ``batch_fn(f, seed)`` (n_points,) over ``seeds``, with f
    the MLP on normalised weights computed once for all the batches."""
    weights = params.normalized()

    def f(x):
        return params(x, weights)

    return torch.mean(torch.stack([batch_fn(f, s) for s in seeds]), dim=0)


def _eval_max_ratio(batch_fn, params, generator, dists, mask,
                    n_eval_batches: int) -> Tensor:
    with torch.no_grad():
        pf = _mean_over(batch_fn, params, _seeds(generator, n_eval_batches))
        diffs = torch.abs(pf[:, None] - pf[None, :])
        return torch.max(torch.where(mask, diffs / dists, 0.0))


# ---------------------------------------------------------------------------
# Public estimators.
# ---------------------------------------------------------------------------

def compute_wasserstein_contraction(
    sample_px: Callable, generator: torch.Generator, X, *,
    sample_batch_size: int = 1000, n_train_batches: int = 10,
    n_eval_batches: int = 100, alpha: float = 10.0, max_steps: int = 100,
    lr: float = 0.1, num_features: int = 32,
):
    """Estimate τ(P) over probe points ``X`` (n_points, d), on the device
    of ``X``.  ``sample_px(seed, X, n_samples)`` draws from the one-step (or
    n-step) kernel at each probe point.  Returns (tau, apply_fn, params)."""
    X = torch.as_tensor(X, dtype=torch.float32)
    dists, mask = _pair_mask(X)

    def batch_mean(f, seed):
        with torch.no_grad():
            batch = sample_px(seed, X, sample_batch_size)
        return _batch_mean(f, batch)

    def mean_fn(params, seeds):
        return _mean_over(batch_mean, params, seeds)

    params = _train_test_fn(
        mean_fn, n_train_batches, generator, X, dists, mask, alpha=alpha,
        max_steps=max_steps, lr=lr, num_features=num_features,
        init_params=None)

    tau = _eval_max_ratio(batch_mean, params, generator, dists, mask,
                          n_eval_batches)
    return tau, apply_lipschitz_mlp, params


def compute_kernel_distance(
    sample_px: Callable, sample_qx: Callable, generator: torch.Generator, X,
    *, sample_batch_size: int = 1000, n_train_batches: int = 10,
    n_eval_batches: int = 100, alpha: float = 10.0, max_steps: int = 100,
    lr: float = 0.1, num_features: int = 32,
    init_params: Optional[LipschitzMLP] = None,
):
    """Estimate the kernel distance ρ(P, Q): the same machinery on
    dPf = Pf − Qf.  P and Q get the same seed per batch (common random
    numbers).  Returns (rho, apply_fn, params); ``init_params`` is trained
    in place."""
    X = torch.as_tensor(X, dtype=torch.float32)
    dists, mask = _pair_mask(X)

    def dmean(f, seed):
        with torch.no_grad():
            bp = sample_px(seed, X, sample_batch_size)
            bq = sample_qx(seed, X, sample_batch_size)
        return _batch_mean(f, bp) - _batch_mean(f, bq)

    def dmean_fn(params, seeds):
        return _mean_over(dmean, params, seeds)

    params = _train_test_fn(
        dmean_fn, n_train_batches, generator, X, dists, mask, alpha=alpha,
        max_steps=max_steps, lr=lr, num_features=num_features,
        init_params=init_params)
    rho = _eval_max_ratio(dmean, params, generator, dists, mask,
                          n_eval_batches)
    return rho, apply_lipschitz_mlp, params


def compute_kernel_distance_1d(
    sample_px: Callable, sample_qx: Callable, generator: torch.Generator, x,
    *, sample_batch_size: int = 10000, n_train_batches: int = 1,
    n_eval_batches: int = 100, max_steps: int = 100, lr: float = 0.1,
    ratio_rad: int = 1, num_features: int = 32,
    init_params: Optional[LipschitzMLP] = None,
):
    """1-D form: the ratios of points ``ratio_rad`` apart on the sorted
    probe grid ``x`` instead of the masked pair matrix, and a hard max loss.
    P and Q get independent seeds per batch."""
    x = torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    X = x[:, None]
    params = (init_lipschitz_mlp(generator, 1, num_features, x.device)
              if init_params is None else init_params)
    grid_dists = torch.abs(x[:-ratio_rad] - x[ratio_rad:])

    def dpf_batch(f, seed_p, seed_q):
        with torch.no_grad():
            bp = sample_px(seed_p, X, sample_batch_size)
            bq = sample_qx(seed_q, X, sample_batch_size)
        return _batch_mean(f, bp) - _batch_mean(f, bq)

    def dpf(params, k):
        seeds = _seeds(generator, 2 * k)
        return _mean_over(lambda f, i: dpf_batch(f, *seeds[2 * i:2 * i + 2]),
                          params, range(k))

    def loss():
        d = dpf(params, n_train_batches)
        return -torch.max(torch.abs(d[:-ratio_rad] - d[ratio_rad:])
                          / grid_dists)

    _adam_train(params, loss, max_steps, lr, 1e-10)
    with torch.no_grad():
        d = dpf(params, n_eval_batches)
        rho = torch.max(torch.abs(d[1:] - d[:-1]) / torch.abs(x[1:] - x[:-1]))
    return rho, apply_lipschitz_mlp, params


def make_sample_px(kernel, adapt_state, n: int = 1, eager: bool = False):
    """The ``sample_px(seed, X, n_samples)`` callable of the estimators for
    a kernel at a frozen adapt state, backed by ``sample_pnx``: the same
    seed gives the same draws, and on the card the rollout's CUDA graph is
    kept from call to call."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import sample_pnx

    def sample_px(seed, X, n_samples):
        return sample_pnx(kernel, seed, X, adapt_state, n=n,
                          n_samples=n_samples, eager=eager)

    return sample_px
