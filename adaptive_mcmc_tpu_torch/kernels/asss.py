"""ASSS — Adaptive Stereographic Slice Sampler (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/kernels/asss.py``, with the same
recursion: map the chain to the unit sphere S^d through an adaptively
whitened stereographic projection, slice-sample along a random great circle
with bracket shrinkage, map back, and adapt (loc, scale) by the running-mean
/ rank-1-Cholesky recursion of ARWMH (no step size):

  * whitening radius (scale + ε I)·√d
  * transformed potential U(x(z)) + d·log(1 − z_{d+1})
  * tangent velocity: N(0, I_{d+1}) projected orthogonal to z, normalized
  * slice level t = U − log u
  * great-circle shrinkage: θ ~ U(0, 2π), bracket [θ − 2π, θ], shrink while
    the potential is above t or the pole distance is below ε; at most
    ``max_shrinkage_iters`` trips, then bail out at θ = 0
  * adaptation with the NaN guard of ARWMH; as_change = ‖Δloc‖₂ + ‖Δscale‖_F

Three drivers:

* ``step`` — one lockstep transition for all chains: the shrinkage loop runs
  until every chain has landed, evaluating the transformed potential for all
  chains on each trip.  Its draws come from a ``torch.Generator`` or, for
  replay, from :class:`ASSSDraws`.  The rank-1 update goes through kernel K1
  (``ops/cholesky.adaptive_scale_update``).  ``probe`` runs it and returns
  the per-chain mean trip count.
* ``step_n`` / ``collect_n`` — the pipelined drivers: each chain runs its own
  draw → shrink → land → adapt machine, one potential evaluation per
  iteration, chains-last, frames written as each chain lands them
  (``ops/cuda/asss_fused.run_machine``, rank-1 update through K1's
  chains-last entry).  The slice level reuses the stored U(x) and the landing
  potential is the accepting trip's U(x').
* with ``ASSSConfig(fused=True)``, ``step_n`` / ``collect_n`` run the same
  machine in one launch of kernel K3 (``ops/cuda/asss_fused.py``), with a
  fresh Philox seed per call drawn from the generator.

The state has no PRNG key: a ``torch.Generator`` comes with every call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from adaptive_mcmc_tpu_torch.kernels.base import (
    Kernel,
    adaptation_lr,
    batch_positions,
    nan_to_inf,
)
from adaptive_mcmc_tpu_torch.ops.cholesky import (
    adaptive_scale_update,
    adaptive_scale_update_cl,
)
from adaptive_mcmc_tpu_torch.ops.cuda.asss_fused import (
    TWO_PI,
    build_fused_asss,
    run_machine,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ASSSConfig:
    lr_decay: float = 2.0 / 3.0
    eps: float = 1e-6
    max_shrinkage_iters: int = 50
    num_warmup: int = 0
    adapt: bool = True
    # step_n / collect_n in one launch of kernel K3.  None resolves to off.
    # Its random streams differ from the plain drivers': equal in
    # distribution only.
    fused: Optional[bool] = None


class ASSSAdaptState(NamedTuple):
    loc: Tensor    # (C, d)
    scale: Tensor  # (C, d, d) lower-triangular


class ASSSState(NamedTuple):
    i: Tensor                  # 0-d int32 iteration
    position: Tensor           # (C, d)
    potential_energy: Tensor   # (C,)
    adapt_state: ASSSAdaptState
    as_change: Tensor          # (C,)


class ASSSDraws(NamedTuple):
    """Injected draws of one lockstep transition."""

    velocity: Tensor   # (C, d+1) normals
    u_level: Tensor    # (C,) slice-level uniform
    u_theta: Tensor    # (C,) initial-angle uniform
    u_shrink: Tensor   # (K, C): chain c reads row k on its own k-th trip


def stereographic_project(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    """R^d -> S^d, whitened by the lower-triangular ``scale``; batched over
    leading axes."""
    xs = x - loc
    xr = torch.linalg.solve_triangular(scale, xs[..., None],
                                       upper=False)[..., 0]
    nsq = torch.sum(xr * xr, dim=-1, keepdim=True)
    z_head = 2.0 * xr / (nsq + 1.0)
    z_last = (nsq - 1.0) / (nsq + 1.0)
    return torch.cat([z_head, z_last], dim=-1)


def stereographic_inverse(z: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    """S^d -> R^d (batched)."""
    x_base = z[..., :-1] / (1.0 - z[..., -1:])
    return torch.einsum("...ij,...j->...i", scale, x_base) + loc


def _shrinkage_batched(z, v, t_pe, transformed_pe, eps: float,
                       max_iters: int, u_theta: Tensor, u_shrink):
    """Batched great-circle shrinkage: per-chain brackets shrink under an
    active mask, and the transformed potential is evaluated for all chains
    on each trip.  ``u_shrink(k)`` gives the (C,) uniforms of trip k; a
    chain that has landed draws nothing more.  Returns the landed sphere
    points and the per-chain trip counts."""
    theta = u_theta * TWO_PI
    tmin, tmax = theta - TWO_PI, theta

    def is_bad(theta):
        z_theta = z * torch.cos(theta)[:, None] + v * torch.sin(theta)[:, None]
        pe = nan_to_inf(transformed_pe(z_theta))
        return (pe > t_pe) | ((1.0 - z_theta[:, -1]) < eps)

    bad = is_bad(theta)
    iters = torch.zeros(theta.shape, dtype=torch.int32, device=theta.device)
    k = 0
    while True:
        active = bad & (iters < max_iters)
        if not bool(active.any()):
            break
        tmin = torch.where(active & (theta < 0.0), theta, tmin)
        tmax = torch.where(active & (theta >= 0.0), theta, tmax)
        theta = torch.where(active, tmin + u_shrink(k) * (tmax - tmin), theta)
        iters = iters + active.to(torch.int32)
        bad = torch.where(active, is_bad(theta), bad)
        k += 1
    theta = torch.where(iters >= max_iters, torch.zeros_like(theta), theta)
    z_f = z * torch.cos(theta)[:, None] + v * torch.sin(theta)[:, None]
    return z_f, iters


def asss(target, config: ASSSConfig = ASSSConfig()) -> Kernel:
    d = target.dim
    potential = target.potential_fn

    def init(generator: Optional[torch.Generator] = None, n_chains: int = 1,
             position=None, adapt_state: Optional[ASSSAdaptState] = None,
             device=None) -> ASSSState:
        pos = batch_positions(target, generator, n_chains, position, device)
        dev = pos.device
        if adapt_state is None:
            adapt_state = ASSSAdaptState(
                loc=pos.clone(),
                scale=torch.eye(d, device=dev).expand(n_chains, d, d)
                .contiguous(),
            )
        return ASSSState(
            i=torch.zeros((), dtype=torch.int32, device=dev),
            position=pos,
            potential_energy=nan_to_inf(potential(pos)),
            adapt_state=adapt_state,
            as_change=torch.zeros(n_chains, device=dev),
        )

    def _transition(state: ASSSState, generator, draws: Optional[ASSSDraws]):
        """One lockstep transition; also returns the per-chain trip
        counts."""
        loc, scale = state.adapt_state
        x = state.position
        C, dev = x.shape[0], x.device
        if draws is None:
            if generator is None:
                raise ValueError("a torch.Generator or injected draws are "
                                 "needed")
            draws = ASSSDraws(
                velocity=torch.randn((C, d + 1), generator=generator,
                                     device=dev),
                u_level=torch.rand((C,), generator=generator, device=dev),
                u_theta=torch.rand((C,), generator=generator, device=dev),
                u_shrink=None,
            )

            def u_shrink(k):
                return torch.rand((C,), generator=generator, device=dev)
        else:
            def u_shrink(k):
                if k >= draws.u_shrink.shape[0]:
                    raise ValueError(f"injected u_shrink has "
                                     f"{draws.u_shrink.shape[0]} rows; trip "
                                     f"{k} needs more")
                return draws.u_shrink[k]

        sigma_sqrt = (scale + config.eps * torch.eye(d, device=dev)) \
            * (d ** 0.5)

        def transformed_pe(z):
            x_flat = stereographic_inverse(z, loc, sigma_sqrt)
            return potential(x_flat) + d * torch.log(1.0 - z[:, -1])

        z = stereographic_project(x, loc, sigma_sqrt)
        pe_t = transformed_pe(z)
        v = draws.velocity
        v = v - torch.sum(v * z, dim=-1, keepdim=True) * z
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        t_pe = pe_t - torch.log(draws.u_level)

        z_new, trips = _shrinkage_batched(
            z, v, t_pe, transformed_pe, config.eps,
            config.max_shrinkage_iters, draws.u_theta, u_shrink,
        )
        x_new = stereographic_inverse(z_new, loc, sigma_sqrt)
        pe_new = nan_to_inf(potential(x_new))

        if config.adapt:
            _, gamma = adaptation_lr(state.i, config.num_warmup,
                                     config.lr_decay)
            delta = x_new - loc
            loc_new = loc + gamma * delta
            scale_new = adaptive_scale_update(scale, delta, gamma.expand(C))
            as_change = torch.linalg.vector_norm(loc_new - loc, dim=-1) \
                + torch.linalg.matrix_norm(scale_new - scale)
            adapt_new = ASSSAdaptState(loc_new, scale_new)
        else:
            adapt_new = state.adapt_state
            as_change = torch.zeros_like(pe_new)

        new_state = ASSSState(
            i=state.i + 1,
            position=x_new,
            potential_energy=pe_new,
            adapt_state=adapt_new,
            as_change=as_change,
        )
        return new_state, trips

    def step(state: ASSSState, generator: Optional[torch.Generator] = None,
             draws: Optional[ASSSDraws] = None) -> ASSSState:
        return _transition(state, generator, draws)[0]

    def probe(state: ASSSState, n_steps: int,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Sequence[ASSSDraws]] = None):
        """Advance ``n_steps`` lockstep transitions exactly as ``step``
        does and return (final_state, per-chain MEAN shrinkage trips per
        transition); ``draws`` holds one :class:`ASSSDraws` per step."""
        total = torch.zeros(state.position.shape[0],
                            device=state.position.device)
        for t in range(n_steps):
            state, trips = _transition(
                state, generator, None if draws is None else draws[t])
            total = total + trips.to(torch.float32)
        return state, total / float(n_steps)

    def _as_tuple(state: ASSSState):
        a = state.adapt_state
        return (state.position, state.potential_energy, a.loc, a.scale,
                state.i, state.as_change)

    if config.fused:
        fused_drive = build_fused_asss(target, config)

        def drive(state_tuple, n_steps, n_frames, thinning, generator):
            return fused_drive(state_tuple, n_steps, n_frames, thinning,
                               generator=generator)
    else:
        def drive(state_tuple, n_steps, n_frames, thinning, generator):
            return run_machine(target, config, state_tuple, n_steps,
                               n_frames, thinning, generator,
                               rank1=adaptive_scale_update_cl)[:2]

    def _run(state: ASSSState, n_steps: int, n_frames: int, thinning: int,
             generator):
        if generator is None:
            raise ValueError("step_n / collect_n need a torch.Generator")
        (x, pe, loc, scale, i, as_change), frames = drive(
            _as_tuple(state), n_steps, n_frames, thinning, generator)
        new = ASSSState(i=i, position=x, potential_energy=pe,
                        adapt_state=ASSSAdaptState(loc, scale),
                        as_change=as_change)
        return new, frames

    def step_n(state: ASSSState, n_steps: int,
               generator: Optional[torch.Generator] = None, *,
               eager: bool = False) -> ASSSState:
        return _run(state, n_steps, 0, 1, generator)[0]

    def collect_n(state: ASSSState, n_frames: int, thinning: int = 1,
                  generator: Optional[torch.Generator] = None, *,
                  eager: bool = False):
        return _run(state, n_frames * thinning, n_frames, thinning,
                    generator)

    return Kernel(
        name="asss",
        target=target,
        config=config,
        init=init,
        step=step,
        step_n=step_n,
        collect_n=collect_n,
        collect_fields=("position", "potential_energy", "as_change"),
        probe=probe,
    )
