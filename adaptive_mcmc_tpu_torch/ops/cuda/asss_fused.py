"""Kernel K3: the fused ASSS sweep, wrapper and plain version.

Replaces the Pallas kernel built by ``build_fused_asss`` in
``adaptive_mcmc_tpu/ops/pallas/asss_fused.py`` (body ``_make_kernel``):
every chain runs its own slice-sampling state machine for ``n_steps``
transitions in one launch, and thinned frames stream out as each chain
lands them.  The CUDA source is ``csrc/asss_fused.cu``, one entry point
``asss_fused_<tag>`` per device potential (``Target.device_potential``):
eight schools noncentered and centered (16 lanes per chain, a row of the
factor per lane), kidiq (16 lanes per chain, the data sum split across
them) and diamonds in its sufficient-statistic form (a warp per chain, a
row of the factor per lane).

``build_fused_asss(target, config)`` returns ``drive(state, n_steps,
n_frames=0, thinning=1, generator=None, unif3=None, n01=None,
return_iters=False)`` with the JAX drive's layouts: ``state`` is ``(x, pe,
loc, scale, i0, as_change)`` chains-first; it returns ``(new_state,
frames)``, ``new_state`` of the same layout with ``i0 + n_steps``, and
``frames`` ``{"position": (C, F, d), "potential_energy": (C, F),
"as_change": (C, F)}`` (empty when ``n_frames == 0``).  With
``return_iters`` it also returns each chain's iteration count (C,) int32.

The state machine (:class:`Machine`, masked chains-last iterations in
blocks of ``GRAPH_ITERS``, for any target): iteration 0 opens each chain's
first transition; every later iteration evaluates the potential once per
chain at its current angle, lands chains whose slice test passes (or that
used ``max_shrinkage_iters`` trips: the bail-out stays put), adapts and
opens the next transition for them, and shrinks the bracket of the others.
The slice level reuses the stored U(x), the landing potential is the
accepting iteration's U(x'), and the adaptation clock is per chain (``i0 +
done``, ``i0`` a tensor).  The host reads ``done`` between blocks only, so
on the card a block replays from a CUDA graph.  The JAX kernel also
evaluates the potential in iteration 0 and discards the result; skipping
that evaluation changes nothing, and iteration 0 still consumes draw row 0.
The pipelined ``step_n`` of ``kernels/asss.py`` runs the same machine with
the rank-1 update through kernel K1.

Draws: injected ``unif3`` (R, 3, C), rows ``(u_shrink, u_level, u_theta)``,
and ``n01`` (R, d+1, C) make a run deterministic.  Chain c reads row
``min(k, R - 1)`` in its own k-th iteration.  Otherwise the kernel draws
from a counter-based Philox4x32-10 seeded from ``generator``, and the plain
version draws from ``generator`` directly: the two agree in distribution,
not bitwise.

Agreement on injected draws.  The kernel has no barrier between chains, so
kernel and plain version consume the same rows and agree in every call.
The JAX kernel synchronises chains at the end of each chunk of 16 frames;
a chain that waits there skips rows.  So the port equals the JAX kernel row
for row when the call has one chunk (``n_frames == 0`` or ``n_frames <=
16``); with more chunks the rows shift after the first barrier and the two
agree in distribution only.

Under CUDA-graph capture the plain version cannot read the device to test
for chains still running, so with injected draws it then runs exactly R
iterations: capture it only with rows for every iteration (an eager call's
iteration counts tell how many).

Dispatch depends on the state's device alone: CPU tensors run
:func:`fused_asss_reference`, CUDA tensors launch the kernel or raise
(``NotImplementedError`` for a target without a device potential, before
anything runs).  ``launches`` counts kernel launches; each launch also
counts ``k3.steps`` (transitions: steps × chains) and, while tracing is
on, ``k3.iters`` (the chains' iterations, summed on the card) with
``utils.profiling.count``, and the machine's blocks count
``asss.machine_iters``.
:func:`device_potential` evaluates a target's device potential alone on
the card, to hold it against ``potential_fn``.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import BlockMachine
from adaptive_mcmc_tpu_torch.kernels.base import nan_to_inf
from adaptive_mcmc_tpu_torch.models.base import sum_in_order
from adaptive_mcmc_tpu_torch.ops.cuda import _build, check_device_potential
from adaptive_mcmc_tpu_torch.ops.cuda.chol_update import (
    chol_update_cl_reference,
)
from adaptive_mcmc_tpu_torch.utils import profiling

Tensor = torch.Tensor

TWO_PI = 6.2831853071795864769
launches = 0
# machine iterations per block: one CUDA graph replay, one host read of
# `done`
GRAPH_ITERS = 16


def sigma_cl(S: Tensor, eps: float) -> Tensor:
    """The whitening factor ``(S + eps I) sqrt(d)`` of a chains-last
    ``(d, d, C)`` scale."""
    d = S.shape[0]
    eye = torch.eye(d, dtype=S.dtype, device=S.device)[:, :, None]
    return (S + eps * eye) * math.sqrt(d)


def project_cl(x: Tensor, loc: Tensor, sig: Tensor) -> Tensor:
    """R^d -> S^d chains-last: ``x``/``loc`` (d, C) to (d+1, C), whitening
    by forward substitution through the lower ``sig`` (d, d, C)."""
    d = x.shape[0]
    ys = x - loc
    rows = []
    for k in range(d):
        xk = ys[k] / sig[k, k]
        rows.append(xk)
        if k + 1 < d:
            ys = ys - sig[:, k] * xk[None]
    xr = torch.stack(rows)
    nsq = sum_in_order(xr * xr, 0)
    z_head = 2.0 * xr / (nsq + 1.0)
    z_last = (nsq - 1.0) / (nsq + 1.0)
    return torch.cat([z_head, z_last[None]])


def inverse_cl(z: Tensor, loc: Tensor, sig: Tensor) -> Tensor:
    """S^d -> R^d chains-last, summing the columns of ``sig`` in order."""
    d = loc.shape[0]
    xb = z[:d] / (1.0 - z[d])
    x = loc
    for j in range(d):
        x = x + sig[:, j] * xb[j][None]
    return x


def begin_cl(n01, u_level, u_theta, x, pe, loc, sig):
    """Open a transition at ``(x, pe)``: sphere point, tangent velocity,
    slice level from the stored potential, angle and bracket."""
    d = x.shape[0]
    z = project_cl(x, loc, sig)
    pe_t = pe + d * torch.log(1.0 - z[d])
    v = n01 - sum_in_order(n01 * z, 0)[None] * z
    v = v / torch.sqrt(sum_in_order(v * v, 0))[None]
    t_pe = pe_t - torch.log(u_level)
    theta = u_theta * TWO_PI
    return z, v, t_pe, theta, theta - TWO_PI, theta


def gamma_cl(i: Tensor, num_warmup: int, lr_decay: float) -> Tensor:
    """Per-chain adaptation rate for global steps ``i`` (C,) int, the clock
    restarting after warmup; ``n^-r`` as ``exp(-r log n)``."""
    itr = i + 1
    nf = torch.where(i < num_warmup, itr, itr - num_warmup).to(torch.float32)
    if lr_decay == 1.0:
        return 1.0 / nf
    return torch.exp(-lr_decay * torch.log(nf))


def rank1_guarded_cl(S: Tensor, delta: Tensor, gamma: Tensor) -> Tensor:
    """``chol((1 - gamma) S Sᵀ + gamma delta deltaᵀ)`` per chain in plain
    PyTorch, keeping the old factor where the update has a NaN."""
    new = chol_update_cl_reference(torch.sqrt(1.0 - gamma) * S, delta, gamma)
    bad = torch.isnan(new).any(dim=0).any(dim=0)
    return torch.where(bad, S, new)


def _count(n: int) -> None:
    profiling.count("asss.machine_iters", n)


class Machine:
    """The ASSS state machine in plain PyTorch, chains-last: iteration 0
    opens each chain's first transition, then blocks of ``GRAPH_ITERS``
    masked iterations run until every chain has made ``n_steps``
    transitions, driven by ``infer.mcmc.BlockMachine`` (``done`` read on
    the host between blocks only; on the card with generator draws each
    block replays from a CUDA graph that draws what the eager blocks draw,
    so the two agree bit for bit; ``step_n`` keeps its graph, ``collect_n``
    captures anew).  Iterations past a chain's end are no-ops for it (they
    still draw).  The first iteration ``i0`` is a tensor in the buffers,
    never a number baked into the graph.

    ``rank1(S, delta, gamma)`` is the guarded rank-1 update on chains-last
    tensors (K1's chains-last kernel on the card for the pipelined driver,
    the plain version for K3's plain version)."""

    def __init__(self, target, config, rank1=None):
        self.target, self.config = target, config
        self.rank1 = rank1 or rank1_guarded_cl
        self.blocks = BlockMachine("asss.step_n", ("fx", "fpe", "fas"))

    def _open(self, st: dict, draw) -> dict:
        x, pe, loc, S = st["x"], st["pe"], st["loc"], st["S"]
        d, C = x.shape
        _, ul, ut, n = draw
        z, v, t_pe, theta, tmin, tmax = begin_cl(
            n, ul, ut, x, pe, loc, sigma_cl(S, float(self.config.eps)))
        zero = torch.zeros(C, dtype=torch.int32, device=x.device)
        return dict(x=x, pe=pe, loc=loc, S=S, ach=st["as"], z=z, v=v,
                    t_pe=t_pe, theta=theta, tmin=tmin, tmax=tmax,
                    trips=zero, done=zero, iters=zero + 1)

    def _iteration(self, p: dict, ctx: dict, draw) -> dict:
        """One masked iteration of every chain."""
        config = self.config
        us, ul, ut, n = draw
        x, pe, loc, S, as_chg = p["x"], p["pe"], p["loc"], p["S"], p["ach"]
        z, v, t_pe, theta = p["z"], p["v"], p["t_pe"], p["theta"]
        tmin, tmax, trips, done = p["tmin"], p["tmax"], p["trips"], p["done"]
        d = x.shape[0]
        eps = float(config.eps)
        active = done < ctx["n_steps"]
        sig = sigma_cl(S, eps)
        z_th = z * torch.cos(theta)[None] + v * torch.sin(theta)[None]
        pole = 1.0 - z_th[d]
        x_prop = inverse_cl(z_th, loc, sig)
        u_prop = nan_to_inf(self.target.potential_fn(x_prop.t()))
        good = (u_prop + d * torch.log(pole) <= t_pe) & (pole >= eps)
        bail = trips >= config.max_shrinkage_iters
        land = active & (good | bail)
        move = land & ~bail
        x = torch.where(move[None], x_prop, x)
        pe = torch.where(move, u_prop, pe)
        if config.adapt:
            gamma = gamma_cl(ctx["i0"] + done, config.num_warmup,
                             config.lr_decay)
            delta = x - loc
            loc_land = loc + gamma * delta
            S_land = self.rank1(S, delta, gamma)
            dl, dS = loc_land - loc, S_land - S
            chg = torch.sqrt(torch.sum(dl * dl, dim=0)) \
                + torch.sqrt(torch.sum(dS * dS, dim=(0, 1)))
            loc = torch.where(land[None], loc_land, loc)
            S = torch.where(land[None, None], S_land, S)
            as_chg = torch.where(land, chg, as_chg)
        done = done + land.to(torch.int32)
        if "fx" in ctx:
            fx, fpe, fas, ar = ctx["fx"], ctx["fpe"], ctx["fas"], ctx["ar"]
            n_frames = fx.shape[0]
            f = done // ctx["thin"] - 1
            rec = land & (done % ctx["thin"] == 0) & (f < n_frames)
            f = f.clamp(0, n_frames - 1)
            fx[f, :, ar] = torch.where(rec[:, None], x.t(), fx[f, :, ar])
            fpe[f, ar] = torch.where(rec, pe, fpe[f, ar])
            fas[f, ar] = torch.where(rec, as_chg, fas[f, ar])
        nz, nv, nt, nth, ntn, ntx = begin_cl(n, ul, ut, x, pe, loc,
                                             sigma_cl(S, eps))
        shrink = active & ~land
        s_tmin = torch.where(shrink & (theta < 0.0), theta, tmin)
        s_tmax = torch.where(shrink & (theta >= 0.0), theta, tmax)
        s_theta = s_tmin + us * (s_tmax - s_tmin)
        return dict(
            x=x, pe=pe, loc=loc, S=S, ach=as_chg,
            z=torch.where(land[None], nz, z),
            v=torch.where(land[None], nv, v),
            t_pe=torch.where(land, nt, t_pe),
            theta=torch.where(land, nth,
                              torch.where(shrink, s_theta, theta)),
            tmin=torch.where(land, ntn, s_tmin),
            tmax=torch.where(land, ntx, s_tmax),
            trips=torch.where(land, 0, trips + shrink.to(torch.int32)),
            done=done, iters=p["iters"] + active.to(torch.int32))

    def run(self, state, n_steps: int, n_frames: int = 0, thinning: int = 1,
            generator=None, unif3=None, n01=None, eager: bool = False):
        """Same arguments as ``drive``; returns ``(new_state, frames,
        iters)``.  ``eager=True`` runs the blocks in a Python loop on the
        card too; injected draws always do."""
        st, frames, i0, inject = _prepare(state, n_steps, n_frames, thinning,
                                          generator, unif3, n01)
        x = st["x"]
        d, C = x.shape
        dev = x.device
        if n_steps == 0 or C == 0:
            return _finish(st, frames, i0, n_steps,
                           torch.zeros(C, dtype=torch.int32, device=dev))
        rows = unif3.shape[0] if inject else 0
        row = itertools.count()

        def draw():
            if inject:
                r = min(next(row), rows - 1)
                return unif3[r, 0], unif3[r, 1], unif3[r, 2], n01[r]
            u = torch.rand((3, C), generator=generator, device=dev)
            n = torch.randn((d + 1, C), generator=generator, device=dev)
            return u[0], 1.0 - u[1], u[2], n

        capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
        graph = x.is_cuda and not (eager or inject or capturing)
        saved = generator.get_state() if graph else None
        p = self._open(st, draw())
        ctx = {"n_steps": torch.full((), n_steps, dtype=torch.int32,
                                     device=dev),
               "i0": i0.to(device=dev, dtype=torch.int32)
               if isinstance(i0, Tensor) else
               torch.full((), i0, dtype=torch.int32, device=dev),
               "thin": torch.full((), thinning, dtype=torch.int32,
                                  device=dev)}
        if frames:
            ctx.update(fx=frames["x"], fpe=frames["pe"], fas=frames["as"],
                       ar=torch.arange(C, device=dev))
        if capturing:
            # under someone else's capture nothing can be read: with
            # injected draws run exactly one iteration per row
            if not inject:
                raise RuntimeError("the ASSS machine reads its progress on "
                                   "the host: capture it only with "
                                   "injected draws")
            for _ in range(rows - 1):
                p = self._iteration(p, ctx, draw())
        else:
            p, ctx = self.blocks.run(
                p, ctx, lambda q, c: self._iteration(q, c, draw()),
                GRAPH_ITERS, _count, generator if graph else None, saved)
        st.update(x=p["x"], pe=p["pe"], loc=p["loc"], S=p["S"],
                  **{"as": p["ach"]})
        if frames:
            frames = {"x": ctx["fx"], "pe": ctx["fpe"], "as": ctx["fas"]}
        return _finish(st, frames, i0, n_steps, p["iters"])


def _prepare(state, n_steps, n_frames, thinning, generator, unif3, n01):
    """Validate a call and make chains-last copies of the state (the
    kernel updates them in place; the caller's state stays as it was) and
    zeroed frame buffers."""
    x, pe, loc, S, i0, as_in = state
    C, d = x.shape
    dev = x.device
    if thinning < 1 or n_frames < 0 or n_frames * thinning > n_steps:
        raise ValueError("need thinning >= 1 and n_frames * thinning <= "
                         "n_steps")
    inject = unif3 is not None
    if inject != (n01 is not None):
        raise ValueError("pass both unif3 and n01, or neither")
    if inject:
        if unif3.dim() != 3 or tuple(unif3.shape[1:]) != (3, C) \
                or unif3.shape[0] < 1 \
                or tuple(n01.shape) != (unif3.shape[0], d + 1, C):
            raise ValueError(
                f"injected draws must be unif3 (R, 3, {C}) and n01 "
                f"(R, {d + 1}, {C}); got {tuple(unif3.shape)} and "
                f"{tuple(n01.shape)}")
    elif generator is None:
        raise ValueError("a torch.Generator or injected draws are needed")

    def copy(t):
        return t.clone(memory_format=torch.contiguous_format)

    st = {"x": copy(x.t()), "pe": copy(pe), "loc": copy(loc.t()),
          "S": copy(S.permute(1, 2, 0)), "as": copy(as_in)}
    frames = {}
    if n_frames:
        frames = {
            "x": torch.zeros((n_frames, d, C), dtype=torch.float32,
                             device=dev),
            "pe": torch.zeros((n_frames, C), dtype=torch.float32, device=dev),
            "as": torch.zeros((n_frames, C), dtype=torch.float32, device=dev),
        }
    return st, frames, i0, inject


def _finish(st, frames, i0, n_steps: int, iters: Tensor):
    """The chains-last results in the drive's return layout, with the
    iteration counts; ``i0`` is an int or a 0-d tensor."""
    dev = st["x"].device
    i = (i0.to(device=dev, dtype=torch.int32) + n_steps) \
        if isinstance(i0, Tensor) else \
        torch.full((), i0 + n_steps, dtype=torch.int32, device=dev)
    new_state = (
        st["x"].t().contiguous(), st["pe"], st["loc"].t().contiguous(),
        st["S"].permute(2, 0, 1).contiguous(), i, st["as"],
    )
    out = {}
    if frames:
        out = {"position": frames["x"].permute(2, 0, 1),      # (C, F, d)
               "potential_energy": frames["pe"].t(),
               "as_change": frames["as"].t()}
    return new_state, out, iters


# argument types of asss_fused_<tag>: 7 pointers, n_data, 5 pointers, 10
# ints, 3 floats, the seed and the stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
             + [ctypes.c_uint64, ctypes.c_void_p])


def kernel_args(config, st: dict, iters: Tensor, kernel_data: Tensor,
                unif3, n01, frames: dict, n_steps: int, n_frames: int,
                thinning: int, i0: int, seed: int) -> list:
    """The arguments of ``asss_fused_<tag>`` but the stream, for the
    chains-last state ``st`` of :func:`_prepare`."""
    d, C = st["x"].shape
    ptr = _build.ptr
    return [
        ptr(st["x"]), ptr(st["pe"]), ptr(st["loc"]), ptr(st["S"]),
        ptr(st["as"]), ptr(iters), ptr(kernel_data), kernel_data.numel(),
        ptr(unif3), ptr(n01), ptr(frames.get("x")), ptr(frames.get("pe")),
        ptr(frames.get("as")),
        C, d, 0 if unif3 is None else unif3.shape[0], n_steps, n_frames,
        thinning, i0, int(config.num_warmup),
        int(config.max_shrinkage_iters), int(bool(config.adapt)),
        float(config.lr_decay), float(config.eps), math.sqrt(d), seed,
    ]


def _launch(target, config, state, n_steps: int, n_frames: int,
            thinning: int, generator, unif3, n01):
    """Run K3 on CUDA tensors; same return as :meth:`Machine.run`."""
    global launches
    tag = check_device_potential(target, "fused ASSS")
    st, frames, i0, inject = _prepare(state, n_steps, n_frames, thinning,
                                      generator, unif3, n01)
    d, C = st["x"].shape
    dev = st["x"].device
    iters = torch.zeros(C, dtype=torch.int32, device=dev)
    if n_steps == 0 or C == 0:
        return _finish(st, frames, i0, n_steps, iters)
    i0 = int(i0)
    seed = 0
    if inject:
        unif3, n01 = unif3.contiguous(), n01.contiguous()
    else:
        seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                                 device=generator.device).item())
    data = target.data.on(dev)["kernel_data"]
    for t in list(st.values()) + [unif3, n01, *frames.values()]:
        if t is not None and (not t.is_cuda or t.device != dev
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError("K3 takes contiguous float32 tensors on one "
                             "CUDA device")
    symbol = f"asss_fused_{tag}"
    fn = _build.function("asss_fused", symbol, _ARGTYPES)
    err = fn(*kernel_args(config, st, iters, data, unif3, n01, frames,
                          n_steps, n_frames, thinning, i0, seed),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, symbol)
    launches += 1
    profiling.count("k3.steps", n_steps * C)
    if profiling.tracing():
        profiling.count("k3.iters", iters.sum())
    return _finish(st, frames, i0, n_steps, iters)


def device_potential(target, x: Tensor) -> Tensor:
    """The target's device potential (``csrc/common.cuh``) at the rows of
    a CUDA ``x`` (C, d), without the NaN guard: one launch of
    ``asss_fused_potential_<tag>``, not counted in ``launches``."""
    tag = check_device_potential(target, "fused ASSS")
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError("device_potential takes a float32 CUDA tensor")
    xt = x.t().contiguous()                                  # (d, C)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    data = target.data.on(x.device)["kernel_data"]
    symbol = f"asss_fused_potential_{tag}"
    fn = _build.function("asss_fused", symbol,
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
    err = fn(xt.data_ptr(), out.data_ptr(), data.data_ptr(), data.numel(),
             x.shape[0], x.shape[1],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, symbol)
    return out


def fused_asss_reference(target, config, state, n_steps: int,
                         n_frames: int = 0, thinning: int = 1,
                         generator=None, unif3=None, n01=None,
                         return_iters: bool = False):
    """Plain PyTorch version of K3 on any device and for any target: the
    state machine of :class:`Machine`, run eagerly, same arguments and
    return layout as ``drive``."""
    out = Machine(target, config).run(state, n_steps, n_frames, thinning,
                                      generator, unif3, n01, eager=True)
    return out if return_iters else out[:2]


def build_fused_asss(target, config):
    """Return the fused ASSS ``drive`` for ``target`` under ``config``."""

    def drive(state, n_steps: int, n_frames: int = 0, thinning: int = 1,
              generator=None, unif3=None, n01=None,
              return_iters: bool = False):
        if not state[0].is_cuda:
            return fused_asss_reference(target, config, state, n_steps,
                                        n_frames, thinning, generator, unif3,
                                        n01, return_iters)
        out = _launch(target, config, state, n_steps, n_frames, thinning,
                      generator, unif3, n01)
        return out if return_iters else out[:2]

    return drive
