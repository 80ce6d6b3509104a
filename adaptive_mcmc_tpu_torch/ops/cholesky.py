"""Rank-1 Cholesky update — the sequential O(d^2) core of covariance
adaptation (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/ops/cholesky.py``:
``chol(L Lᵀ + coef v vᵀ)`` from the existing factor by the LDLᵀ form of the
rank-one modification (Gill, Golub, Murray & Saunders 1974, method C1).
The single-factor :func:`rank1_cholesky_update` is the unit-lower form of the
JAX scan; the batched and chains-last entries go to kernel K1
(``ops/cuda/chol_update.py``), which runs its plain PyTorch version for a
CPU tensor and the CUDA kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from adaptive_mcmc_tpu_torch.ops.cuda.chol_update import (
    chol_update,
    chol_update_cl,
    chol_update_cl_reference as _rank1_update_cl,  # noqa: F401
)

Tensor = torch.Tensor


def rank1_cholesky_update(L: Tensor, v: Tensor, coef=1.0) -> Tensor:
    """Return ``chol(L @ L.T + coef * outer(v, v))`` (lower triangular) for
    one ``(d, d)`` factor; an indefinite downdate gives NaN."""
    d = L.shape[-1]
    diag = torch.diagonal(L)
    unit_L = L / diag[None, :]
    D = diag * diag
    a = torch.as_tensor(coef, dtype=L.dtype, device=L.device)
    w = v.to(L.dtype)
    cols, D_new = [], []
    for j in range(d):
        Lj, Dj = unit_L[:, j], D[j]
        p = w[j]
        Dj_new = Dj + a * p * p
        beta = p * a / Dj_new
        a = a * Dj / Dj_new
        w = w - p * Lj
        cols.append(Lj + beta * w)
        D_new.append(Dj_new)
    out = torch.stack(cols, dim=1) * torch.sqrt(torch.stack(D_new))[None, :]
    return torch.tril(out)


def rank1_cholesky_update_batched(L: Tensor, v: Tensor, coef) -> Tensor:
    """Batched ``chol(L_i L_iᵀ + coef_i v_i v_iᵀ)``: ``L`` (C, d, d), ``v``
    (C, d), ``coef`` scalar or (C,).  Goes through kernel K1."""
    coef = torch.as_tensor(coef, dtype=L.dtype, device=L.device)
    return chol_update(L, v, coef.expand(L.shape[0]).contiguous())


def adaptive_scale_update(L: Tensor, delta: Tensor, gamma,
                          eps_nan_guard: bool = True) -> Tensor:
    """One covariance-adaptation step:

        L' = chol((1 - γ) L Lᵀ + γ δ δᵀ)   via  rank1(√(1-γ)·L, δ, γ)

    keeping the old factor where the update produced any NaN (per chain for
    batched (C, d, d) / (C, d) inputs)."""
    gamma = torch.as_tensor(gamma, dtype=L.dtype, device=L.device)
    if L.dim() == 2:
        new = rank1_cholesky_update(torch.sqrt(1.0 - gamma) * L, delta, gamma)
        if not eps_nan_guard:
            return new
        return L if bool(torch.isnan(new).any()) else new
    gamma = gamma.expand(L.shape[0])
    scaled = torch.sqrt(1.0 - gamma)[:, None, None] * L
    new = rank1_cholesky_update_batched(scaled, delta, gamma)
    if not eps_nan_guard:
        return new
    bad = torch.isnan(new).any(dim=-1).any(dim=-1)
    return torch.where(bad[:, None, None], L, new)


def adaptive_scale_update_cl(L: Tensor, delta: Tensor, gamma,
                             eps_nan_guard: bool = True) -> Tensor:
    """Chains-last twin of :func:`adaptive_scale_update`: ``L`` (d, d, C),
    ``delta`` (d, C), ``gamma`` (C,); goes through K1's native layout."""
    gamma = torch.as_tensor(gamma, dtype=L.dtype, device=L.device)
    gamma = gamma.expand(L.shape[-1]).contiguous()
    scaled = torch.sqrt(1.0 - gamma)[None, None, :] * L
    new = chol_update_cl(scaled, delta, gamma)
    if not eps_nan_guard:
        return new
    bad = torch.isnan(new).any(dim=0).any(dim=0)
    return torch.where(bad[None, None, :], L, new)
