"""The ARWMH lockstep step's kernels around the target's potential: wrappers.

On a CUDA state ``kernels/arwmh.py``'s ``step`` runs

    draws -> :func:`propose` -> ``potential_fn`` -> :func:`accept` -> K1
    (``chol_update``) -> :func:`settle`

where the plain step launches some fifty PyTorch operators for the same
arithmetic.  The CUDA source is ``csrc/arwmh_step.cu``, which replaces no TPU
kernel (the JAX step is one jitted program).  The plain versions are
``propose_plain``, ``accept_plain`` and ``settle_plain`` in
``kernels/arwmh.py``, which a CPU state runs; these wrappers take CUDA
tensors only and launch their kernel or raise.  Each checks devices, dtypes
and shapes; a strided view is copied first (the step passes dense tensors),
and every output is a fresh tensor.  Nothing is read on the host, so the
step can be captured into a CUDA graph.

``propose_launches``, ``accept_launches`` and ``settle_launches`` count the
launches of each kernel (``ops.cuda.launch_counts``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from adaptive_mcmc_tpu_torch.ops.cuda import _build

Tensor = torch.Tensor

propose_launches = 0
accept_launches = 0
settle_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "arwmh_propose": [_P] * 4 + [_F, _P, _I, _I, _P],
    "arwmh_accept": [_P] * 18 + [_I] * 4 + [_F, _F, _I, _P],
    "arwmh_settle": [_P] * 8 + [_I, _I, _P],
}

# csrc/arwmh_step.cu's PowMode by lr_decay: adaptation_lr's own 1 / n, the
# rsqrt that PyTorch's pow(Tensor, Scalar) takes for the exponent -0.5;
# powf for any other
_POW_MODES = {1.0: 1, 0.5: 2}


def pow_mode(lr_decay: float) -> tuple:
    """(mode, float32 exponent) of adaptation_lr's gamma = n^(-lr_decay) in
    the accept kernel."""
    return (_POW_MODES.get(float(lr_decay), 0),
            ctypes.c_float(-float(lr_decay)).value)


class Accepted(NamedTuple):
    """The accept step's results; the adaptation's fields are None when the
    sampler does not adapt."""

    position: Tensor                 # (C, d)
    potential_energy: Tensor         # (C,)
    mean_accept_prob: Tensor         # (C,)
    loc: Optional[Tensor] = None     # (C, d)  mu'
    log_step_size: Optional[Tensor] = None  # (C,)  log lam'
    scaled: Optional[Tensor] = None  # (C, d, d)  sqrt(1 - gamma) L, for K1
    delta: Optional[Tensor] = None   # (C, d)  x_new - mu, for K1
    gamma: Optional[Tensor] = None   # (C,)  K1's coefficient


def _dense(name: str, t: Tensor, shape: tuple, device,
           dtype=torch.float32) -> Tensor:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return t.contiguous()


def _call(symbol: str, *args) -> None:
    fn = _build.function("arwmh_step", symbol, _ARGTYPES[symbol])
    _build.check(fn(*args), symbol)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _size(t: Tensor, rank: int) -> tuple:
    """(C, d) of a CUDA tensor ``t`` of shape (C, d) (rank 2) or (C, d, d)
    (rank 3), or raises."""
    if not t.is_cuda:
        raise ValueError("the ARWMH step kernels take CUDA tensors; a CPU "
                         "state runs kernels/arwmh.py's plain versions")
    if t.dim() != rank:
        raise ValueError(f"expected {rank} axes, got {tuple(t.shape)}")
    return t.shape[0], t.shape[-1]


def propose(x: Tensor, L: Tensor, log_lam: Tensor, noise: Tensor,
            eps: float) -> Tensor:
    """``x + (L e^lam + eps I) noise`` per chain: ``x``, ``noise`` (C, d),
    ``L`` (C, d, d), ``log_lam`` (C,)."""
    global propose_launches
    C, d = _size(x, 2)
    dev = x.device
    x = _dense("x", x, (C, d), dev)
    L = _dense("L", L, (C, d, d), dev)
    log_lam = _dense("log_lam", log_lam, (C,), dev)
    noise = _dense("noise", noise, (C, d), dev)
    out = torch.empty_like(x)
    if C:
        _call("arwmh_propose", x.data_ptr(), L.data_ptr(), log_lam.data_ptr(),
              noise.data_ptr(), eps, out.data_ptr(), C, d, _stream(dev))
        propose_launches += 1
    return out


def accept(x: Tensor, pe: Tensor, x_prop: Tensor, pe_prop: Tensor,
           u: Tensor, mean_ap: Tensor, i: Tensor, loc: Tensor, L: Tensor,
           log_lam: Tensor, *, num_warmup: int, lr_decay: float,
           target_accept_prob: float, adapt: bool) -> Accepted:
    """The MH select of ``x_prop`` (potential ``pe_prop``, NaN rejects) by
    the uniforms ``u``, the running mean of acceptance on the clock ``i``
    (a 0-d int32 tensor) and, with ``adapt``, the adaptation's updates and
    K1's inputs (:class:`Accepted`)."""
    global accept_launches
    C, d = _size(x, 2)
    dev = x.device
    vec, one = (C, d), (C,)
    x, x_prop, loc = (_dense(n, t, vec, dev) for n, t in
                      (("x", x), ("x_prop", x_prop), ("loc", loc)))
    pe, pe_prop, u, mean_ap, log_lam = (
        _dense(n, t, one, dev) for n, t in
        (("pe", pe), ("pe_prop", pe_prop), ("u", u), ("mean_ap", mean_ap),
         ("log_lam", log_lam)))
    L = _dense("L", L, (C, d, d), dev)
    i = _dense("i", i, (), dev, torch.int32)
    out = Accepted(torch.empty_like(x), torch.empty_like(pe),
                   torch.empty_like(pe))
    if adapt:
        out = out._replace(loc=torch.empty_like(x),
                           log_step_size=torch.empty_like(pe),
                           scaled=torch.empty_like(L),
                           delta=torch.empty_like(x),
                           gamma=torch.empty_like(pe))
    if C:
        mode, exponent = pow_mode(lr_decay)
        _call("arwmh_accept", *(_build.ptr(t) for t in (
            x, pe, x_prop, pe_prop, u, mean_ap, i, loc, L, log_lam,
            out.position, out.potential_energy, out.mean_accept_prob,
            out.loc, out.log_step_size, out.delta, out.scaled, out.gamma)),
            C, d, num_warmup, mode, exponent, target_accept_prob, int(adapt),
            _stream(dev))
        accept_launches += 1
    return out


def settle(L: Tensor, updated: Tensor, log_lam: Tensor, log_lam_new: Tensor,
           i: Tensor) -> tuple:
    """``(L', as_change, i + 1)`` after K1: ``L'`` is ``updated`` where it
    holds no NaN, else ``L``, per chain; ``as_change`` is ``|L' e^lam' -
    L e^lam|_F``."""
    global settle_launches
    C, d = _size(L, 3)
    dev = L.device
    L = _dense("L", L, (C, d, d), dev)
    updated = _dense("updated", updated, (C, d, d), dev)
    log_lam = _dense("log_lam", log_lam, (C,), dev)
    log_lam_new = _dense("log_lam_new", log_lam_new, (C,), dev)
    i = _dense("i", i, (), dev, torch.int32)
    L_new, as_change, i_new = (torch.empty_like(L), torch.empty_like(log_lam),
                               torch.empty_like(i))
    if C:
        _call("arwmh_settle", L.data_ptr(), updated.data_ptr(),
              log_lam.data_ptr(), log_lam_new.data_ptr(), i.data_ptr(),
              L_new.data_ptr(), as_change.data_ptr(), i_new.data_ptr(), C, d,
              _stream(dev))
        settle_launches += 1
    else:
        i_new = i + 1
    return L_new, as_change, i_new
