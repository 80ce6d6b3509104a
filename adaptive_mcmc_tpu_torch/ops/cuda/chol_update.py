"""Kernel K1: batched rank-1 Cholesky update, wrappers and plain versions.

Replaces the Pallas kernel ``_kernel`` of
``adaptive_mcmc_tpu/ops/pallas/chol_update.py`` (launched from
``chol_update_pallas_cl`` / ``chol_update_pallas``).  The CUDA source is
``csrc/chol_update.cu``, one kernel per layout of the caller's state:
:func:`chol_update` takes chains first, ``(C, d, d)``, as the samplers'
lockstep steps hold it, and :func:`chol_update_cl` chains last,
``(d, d, C)``, as the pipelined ASSS machine holds it.  Neither makes a
transposing copy.

Dispatch depends on the tensor's device alone: a CPU tensor goes to the plain
PyTorch version (:func:`chol_update_reference`,
:func:`chol_update_cl_reference`), a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches of both entries.
"""

from __future__ import annotations

import ctypes

import torch

from adaptive_mcmc_tpu_torch.ops.cuda import _build

Tensor = torch.Tensor

MAX_D = 32
launches = 0


def chol_update_cl_reference(Lt: Tensor, vt: Tensor, coef: Tensor) -> Tensor:
    """Plain version, chains-last: ``chol(L Lᵀ + coef·v vᵀ)`` for ``Lt``
    (d, d, C), ``vt`` (d, C), ``coef`` (C,) by the GGMS74-C1 column
    recursion, reassociated as in the Pallas kernel; entries above the
    diagonal are zeroed.  An indefinite downdate gives NaN."""
    d = Lt.shape[0]
    a, w = coef, vt
    rows = torch.arange(d, device=Lt.device)[:, None]
    cols = []
    for j in range(d):
        col = Lt[:, j, :]                    # (d, C)
        diag = Lt[j, j, :]                   # (C,)
        inv_diag = 1.0 / diag
        Dj = diag * diag
        p = w[j, :]
        Dj_new = Dj + a * p * p
        inv_Dj_new = 1.0 / Dj_new
        sqrt_Dj_new = torch.sqrt(Dj_new)
        s_w = p * inv_diag
        s_col = sqrt_Dj_new * inv_diag
        s_new = (p * a) * inv_Dj_new * sqrt_Dj_new
        a = a * Dj * inv_Dj_new
        w = w - s_w[None, :] * col
        col_new = s_col[None, :] * col + s_new[None, :] * w
        cols.append(torch.where(rows >= j, col_new,
                                torch.zeros_like(col_new)))
    return torch.stack(cols, dim=1)          # (d, d, C)


def chol_update_reference(L: Tensor, v: Tensor, coef: Tensor) -> Tensor:
    """Plain version, chains-first: ``L`` (C, d, d), ``v`` (C, d)."""
    out = chol_update_cl_reference(L.permute(1, 2, 0), v.t(), coef)
    return out.permute(2, 0, 1)


def _check_args(L: Tensor, v: Tensor, coef: Tensor,
                chains_last: bool) -> tuple:
    """(d, C) of well-formed arguments in the given layout, or raises."""
    if L.dim() != 3:
        raise ValueError(f"L must have three axes, got {tuple(L.shape)}")
    d, C = (L.shape[0], L.shape[2]) if chains_last \
        else (L.shape[1], L.shape[0])
    want = ((d, d, C), (d, C), (C,)) if chains_last \
        else ((C, d, d), (C, d), (C,))
    got = tuple(tuple(t.shape) for t in (L, v, coef))
    if got != want:
        raise ValueError(f"L, v and coef must be {want}, got {got}")
    for t in (L, v, coef):
        if t.dtype != torch.float32:
            raise TypeError(f"K1 takes float32, got {t.dtype}")
        if t.device != L.device:
            raise ValueError("L, v and coef must be on one device")
    return d, C


def _launch(L: Tensor, v: Tensor, coef: Tensor, chains_last: bool) -> Tensor:
    global launches
    d, C = _check_args(L, v, coef, chains_last)
    if not 1 <= d <= MAX_D:
        raise ValueError(f"K1 supports 1 <= d <= {MAX_D}, got d={d}")
    symbol = "chol_update_cl" if chains_last else "chol_update"
    fn = _build.function(
        "chol_update", symbol,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    )
    # the kernels index dense arrays: a strided view is copied first (the
    # samplers pass contiguous tensors)
    L, v, coef = L.contiguous(), v.contiguous(), coef.contiguous()
    out = torch.empty_like(L)
    if C:
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = fn(L.data_ptr(), v.data_ptr(), coef.data_ptr(),
                 out.data_ptr(), d, C, stream)
        _build.check(err, symbol)
        launches += 1
    return out


def chol_update_cl(Lt: Tensor, vt: Tensor, coef: Tensor) -> Tensor:
    """Chains-last entry: ``Lt`` (d, d, C), ``vt`` (d, C), ``coef`` (C,)."""
    if Lt.is_cuda:
        return _launch(Lt, vt, coef, chains_last=True)
    _check_args(Lt, vt, coef, chains_last=True)
    return chol_update_cl_reference(Lt, vt, coef)


def chol_update(L: Tensor, v: Tensor, coef: Tensor) -> Tensor:
    """Chains-first entry: ``L`` (C, d, d), ``v`` (C, d), ``coef`` (C,)."""
    if L.is_cuda:
        return _launch(L, v, coef, chains_last=False)
    _check_args(L, v, coef, chains_last=False)
    return chol_update_reference(L, v, coef).contiguous()
