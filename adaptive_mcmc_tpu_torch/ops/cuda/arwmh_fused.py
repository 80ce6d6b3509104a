"""Kernel K2: the fused ARWMH sweep, wrapper and plain version.

Replaces the Pallas kernel built by ``build_fused_arwmh`` in
``adaptive_mcmc_tpu/ops/pallas/arwmh_fused.py`` (body ``_make_kernel`` /
``_one_step``): ``n_steps`` whole ARWMH transitions in one launch with the
chain state on chip, thinned frames streamed out.  The CUDA source is
``csrc/arwmh_fused.cu``: the state in registers, one thread per
eight-schools chain (d = 10), a warp per diamonds chain (d = 26) with a row
of the factor per lane, and 16 lanes per kidiq chain.

``build_fused_arwmh(target, config)`` returns
``drive(state, n_steps, n_frames=0, thinning=1, generator=None, noise=None,
unif=None)`` with the JAX drive's layouts: ``state`` is
``(x, pe, map, loc, L, loglam, i0)`` chains-first; it returns
``(new_state, frames)`` where ``new_state`` gains a trailing ``as_change``
(C,) and ``frames`` is ``{"position": (C, F, d), "potential_energy": (C, F),
"as_change": (C, F)}`` (empty when ``n_frames == 0``).

Draws: injected ``noise`` (S, C, d) and ``unif`` (S, C) make a run
deterministic.  Otherwise the kernel draws from a counter-based
Philox4x32-10 seeded from ``generator``, and the plain version draws from
``generator`` directly: the two agree in distribution, not bitwise.

The kernel has one entry point ``arwmh_fused_<tag>`` per device potential
(eight schools noncentered and centered, kidiq, diamonds in its
sufficient-statistic form); ``build_fused_arwmh`` raises
``NotImplementedError`` for any other target.  Dispatch depends on the state's device alone:
CPU tensors run :func:`fused_arwmh_reference`, CUDA tensors launch the
kernel or raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from adaptive_mcmc_tpu_torch.kernels.base import nan_to_inf
from adaptive_mcmc_tpu_torch.ops.cuda import _build, check_device_potential
from adaptive_mcmc_tpu_torch.ops.cuda.chol_update import (
    chol_update_cl_reference,
)

Tensor = torch.Tensor

launches = 0


def _gamma_of(i: int, num_warmup: int, lr_decay: float, device):
    """(n, gamma) as float32 device scalars for global step ``i``, with the
    clock restarting after warmup; ``n^-r`` as ``exp(-r log n)``."""
    itr = i + 1
    n = itr if i < num_warmup else itr - num_warmup
    nf = torch.full((), float(n), dtype=torch.float32, device=device)
    if lr_decay == 1.0:
        return nf, 1.0 / nf
    return nf, torch.exp(-lr_decay * torch.log(nf))


def _steps_cl(target, config, st: dict, i0: int, n_steps: int,
              n_frames: int, thinning: int, generator, noise, unif,
              frames: dict) -> None:
    """The plain step loop on chains-last tensors, mirroring the kernel's
    operation order; updates ``st`` and ``frames`` in place."""
    x, pe, map_, loc, L, lam, as_chg = (
        st["x"], st["pe"], st["map"], st["loc"], st["L"], st["lam"],
        st["as"],
    )
    d, C = x.shape
    dev = x.device
    eps, target_ap = float(config.eps), float(config.target_accept_prob)
    for s in range(n_steps):
        if noise is not None:
            z, u = noise[s], unif[s]
        else:
            z = torch.randn((d, C), generator=generator, device=dev)
            u = torch.rand((C,), generator=generator, device=dev)
        ss = torch.exp(lam)
        y = eps * z
        for j in range(d):
            y = y + (L[:, j, :] * ss) * z[j:j + 1, :]
        x_prop = x + y
        pe_prop = nan_to_inf(target.potential_fn(x_prop.t()))
        ap = torch.exp(pe - pe_prop).clamp_max(1.0)
        acc = u < ap
        x_new = torch.where(acc[None, :], x_prop, x)
        pe_new = torch.where(acc, pe_prop, pe)

        nf, gamma = _gamma_of(i0 + s, config.num_warmup, config.lr_decay,
                              dev)
        map_new = map_ + (ap - map_) / nf
        delta = x_new - loc
        loc_new = loc + gamma * delta
        L_up = chol_update_cl_reference(
            torch.sqrt(1.0 - gamma) * L, delta, gamma.expand(C)
        )
        bad = torch.isnan(L_up).any(dim=0).any(dim=0)
        L_new = torch.where(bad[None, None, :], L, L_up)
        lam_new = lam + gamma * (ap - target_ap)

        f = (s + 1) // thinning - 1
        is_frame = n_frames > 0 and (s + 1) % thinning == 0 and f < n_frames
        if is_frame or s == n_steps - 1:
            diff = L_new * torch.exp(lam_new) - L * torch.exp(lam)
            as_chg = torch.sqrt(torch.sum(diff * diff, dim=(0, 1)))
        if is_frame:
            frames["x"][f] = x_new
            frames["pe"][f] = pe_new
            frames["as"][f] = as_chg
        x, pe, map_, loc, L, lam = x_new, pe_new, map_new, loc_new, L_new, \
            lam_new
    st.update(x=x, pe=pe, map=map_, loc=loc, L=L, lam=lam, **{"as": as_chg})


# argument types of arwmh_fused_<tag>: 8 pointers, n_data, 5 pointers, 7
# ints, 3 floats, the seed and the stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
             + [ctypes.c_uint64, ctypes.c_void_p])


def kernel_args(config, st: dict, kernel_data: Tensor, i0: int,
                n_steps: int, n_frames: int, thinning: int, noise, unif,
                frames: dict, seed: int) -> list:
    """The arguments of ``arwmh_fused_<tag>`` but the stream, for the
    chains-last state ``st`` of :func:`_drive`."""
    d, C = st["x"].shape
    ptr = _build.ptr
    return [
        ptr(st["x"]), ptr(st["pe"]), ptr(st["map"]), ptr(st["loc"]),
        ptr(st["L"]), ptr(st["lam"]), ptr(st["as"]), ptr(kernel_data),
        kernel_data.numel(), ptr(noise), ptr(unif), ptr(frames.get("x")),
        ptr(frames.get("pe")), ptr(frames.get("as")),
        C, d, n_steps, n_frames, thinning, i0, int(config.num_warmup),
        float(config.lr_decay), float(config.target_accept_prob),
        float(config.eps), seed,
    ]


def _launch_cl(target, config, st: dict, i0: int, n_steps: int,
               n_frames: int, thinning: int, generator, noise, unif,
               frames: dict) -> None:
    """Launch K2 on chains-last CUDA tensors; updates ``st`` in place."""
    global launches
    tag = check_device_potential(target, "fused ARWMH")
    C = st["x"].shape[1]
    dev = st["x"].device
    if n_steps == 0 or C == 0:
        return
    if noise is None:
        if generator is None:
            raise ValueError("K2 needs a torch.Generator or injected draws")
        seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                                 device=generator.device).item())
    else:
        seed = 0
    data = target.data.on(dev)["kernel_data"]
    for t in list(st.values()) + [noise, unif, *frames.values()]:
        if t is not None and (not t.is_cuda or t.device != dev
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError("K2 takes contiguous float32 tensors on one "
                             "CUDA device")
    symbol = f"arwmh_fused_{tag}"
    fn = _build.function("arwmh_fused", symbol, _ARGTYPES)
    err = fn(*kernel_args(config, st, data, i0, n_steps, n_frames, thinning,
                          noise, unif, frames, seed),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, symbol)
    launches += 1


def _drive(target, config, state, n_steps: int, n_frames: int,
           thinning: int, generator, noise, unif, use_kernel: bool):
    x, pe, map_, loc, L, loglam, i0 = state
    i0 = int(i0)
    C, d = x.shape
    dev = x.device
    if n_frames and n_frames * thinning > n_steps:
        raise ValueError("n_frames * thinning exceeds n_steps")
    if (noise is None) != (unif is None):
        raise ValueError("pass both noise and unif, or neither")
    if noise is not None:
        if tuple(noise.shape[1:]) != (C, d) or noise.shape[0] < n_steps \
                or tuple(unif.shape[1:]) != (C,) or unif.shape[0] < n_steps:
            raise ValueError(
                f"injected draws must be noise (S>={n_steps}, {C}, {d}) and "
                f"unif (S, {C}); got {tuple(noise.shape)} and "
                f"{tuple(unif.shape)}"
            )
        noise = noise[:n_steps].permute(0, 2, 1).contiguous()  # (S, d, C)
        unif = unif[:n_steps].contiguous()
    # fresh chains-last copies: the kernel updates them in place, and the
    # caller's state must stay as it was
    def copy(t):
        return t.clone(memory_format=torch.contiguous_format)

    st = {
        "x": copy(x.t()), "pe": copy(pe), "map": copy(map_),
        "loc": copy(loc.t()), "L": copy(L.permute(1, 2, 0)),
        "lam": copy(loglam),
        "as": torch.zeros(C, dtype=torch.float32, device=dev),
    }
    frames = {}
    if n_frames:
        frames = {
            "x": torch.zeros((n_frames, d, C), dtype=torch.float32,
                             device=dev),
            "pe": torch.zeros((n_frames, C), dtype=torch.float32, device=dev),
            "as": torch.zeros((n_frames, C), dtype=torch.float32, device=dev),
        }
    run = _launch_cl if use_kernel else _steps_cl
    run(target, config, st, i0, n_steps, n_frames, thinning, generator,
        noise, unif, frames)
    new_state = (
        st["x"].t().contiguous(), st["pe"], st["map"],
        st["loc"].t().contiguous(), st["L"].permute(2, 0, 1).contiguous(),
        st["lam"],
        torch.full((), i0 + n_steps, dtype=torch.int32, device=dev),
        st["as"],
    )
    out_frames = {}
    if n_frames:
        out_frames = {
            "position": frames["x"].permute(2, 0, 1),       # (C, F, d)
            "potential_energy": frames["pe"].t(),
            "as_change": frames["as"].t(),
        }
    return new_state, out_frames


def fused_arwmh_reference(target, config, state, n_steps: int,
                          n_frames: int = 0, thinning: int = 1,
                          generator=None, noise=None, unif=None):
    """Plain PyTorch version of K2 on any device: a torch loop of the step
    math in the kernel's operation order, same arguments and return layout
    as ``drive``."""
    check_device_potential(target, "fused ARWMH")
    if noise is None and generator is None:
        raise ValueError("a torch.Generator or injected draws are needed")
    return _drive(target, config, state, n_steps, n_frames, thinning,
                  generator, noise, unif, use_kernel=False)


def build_fused_arwmh(target, config):
    """Return the fused ARWMH ``drive`` for ``target`` under ``config``."""
    check_device_potential(target, "fused ARWMH")

    def drive(state, n_steps: int, n_frames: int = 0, thinning: int = 1,
              generator=None, noise=None, unif=None):
        if state[0].is_cuda:
            return _drive(target, config, state, n_steps, n_frames,
                          thinning, generator, noise, unif, use_kernel=True)
        return fused_arwmh_reference(target, config, state, n_steps,
                                     n_frames, thinning, generator, noise,
                                     unif)

    return drive
