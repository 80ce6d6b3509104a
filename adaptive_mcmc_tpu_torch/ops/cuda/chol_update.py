"""Kernel K1: batched rank-1 Cholesky update, wrapper and plain version.

Replaces the Pallas kernel ``_kernel`` of
``adaptive_mcmc_tpu/ops/pallas/chol_update.py`` (launched from
``chol_update_pallas_cl`` / ``chol_update_pallas``).  The CUDA source is
``csrc/chol_update.cu``: one thread per chain over the chains-last
``(d, d, C)`` layout.

Dispatch depends on the tensor's device alone: a CPU tensor goes to the plain
PyTorch version (:func:`chol_update_cl_reference`), a CUDA tensor launches
the kernel or raises.  ``launches`` counts kernel launches.
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


def _check_args(Lt: Tensor, vt: Tensor, coef: Tensor) -> tuple:
    if Lt.dim() != 3 or Lt.shape[0] != Lt.shape[1]:
        raise ValueError(f"Lt must be (d, d, C), got {tuple(Lt.shape)}")
    d, _, C = Lt.shape
    if tuple(vt.shape) != (d, C) or tuple(coef.shape) != (C,):
        raise ValueError(
            f"vt must be {(d, C)} and coef {(C,)}, got "
            f"{tuple(vt.shape)} and {tuple(coef.shape)}"
        )
    for t in (Lt, vt, coef):
        if t.dtype != torch.float32:
            raise TypeError(f"K1 takes float32, got {t.dtype}")
        if t.device != Lt.device:
            raise ValueError("Lt, vt and coef must be on one device")
    return d, C


def _launch(Lt: Tensor, vt: Tensor, coef: Tensor) -> Tensor:
    global launches
    d, C = _check_args(Lt, vt, coef)
    if not 1 <= d <= MAX_D:
        raise ValueError(f"K1 supports 1 <= d <= {MAX_D}, got d={d}")
    fn = _build.function(
        "chol_update", "chol_update_cl",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    )
    Lt, vt, coef = Lt.contiguous(), vt.contiguous(), coef.contiguous()
    out = torch.empty_like(Lt)
    if C:
        stream = torch.cuda.current_stream(Lt.device).cuda_stream
        err = fn(Lt.data_ptr(), vt.data_ptr(), coef.data_ptr(),
                 out.data_ptr(), d, C, stream)
        _build.check(err, "chol_update_cl")
        launches += 1
    return out


def chol_update_cl(Lt: Tensor, vt: Tensor, coef: Tensor) -> Tensor:
    """Chains-last entry: ``Lt`` (d, d, C), ``vt`` (d, C), ``coef`` (C,)."""
    if Lt.is_cuda:
        return _launch(Lt, vt, coef)
    _check_args(Lt, vt, coef)
    return chol_update_cl_reference(Lt, vt, coef)


def chol_update(L: Tensor, v: Tensor, coef: Tensor) -> Tensor:
    """Chains-first entry: ``L`` (C, d, d), ``v`` (C, d), ``coef`` (C,);
    transposes to the kernel's chains-last layout and back."""
    out = chol_update_cl(L.permute(1, 2, 0), v.t(), coef)
    return out.permute(2, 0, 1).contiguous()
