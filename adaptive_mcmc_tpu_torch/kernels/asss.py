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
  in blocks of ``SHRINK_TRIPS`` masked trips until every chain has landed,
  evaluating the transformed potential for all chains on each trip, the
  active mask read on the host once per block.  Its draws come from a
  ``torch.Generator`` or, for replay, from :class:`ASSSDraws`.  The rank-1
  update goes through kernel K1 (``ops/cholesky.adaptive_scale_update``).
  ``probe`` runs it and returns the per-chain mean trip count.  The step's
  parts (before the loop, one trip, after it: ``Kernel.step_parts``)
  replay from CUDA graphs on the card
  (``infer.mcmc.LockstepGraph``: ``run_mcmc`` and ``advancer`` with
  ``step_n=None``, ``probe``, ``sample_pnx``), with the draws of the
  Python loop over the same blocks.
* ``step_n`` / ``collect_n`` — the pipelined drivers: each chain runs its own
  draw → shrink → land → adapt machine, one potential evaluation per
  iteration, chains-last, frames written as each chain lands them
  (``ops/cuda/asss_fused.Machine``, rank-1 update through K1's chains-last
  entry).  The slice level reuses the stored U(x) and the landing potential
  is the accepting trip's U(x').  The iterations run in blocks of
  ``GRAPH_ITERS``; on the card each block replays from a CUDA graph
  (``step_n`` keeps its graph for the next call of the same shape and
  generator, ``collect_n`` captures its own), and ``eager=True`` runs the
  same blocks in a Python loop with the same draws.
* with ``ASSSConfig(fused=True)``, ``step_n`` / ``collect_n`` run the same
  machine in one launch of kernel K3 (``ops/cuda/asss_fused.py``), with a
  fresh Philox seed per call drawn from the generator.  ``fused=None``
  resolves to K3 where a CUDA device is present and ``AMT_ASSS_FUSED=1``
  (the JAX package's opt-in), otherwise to the pipelined machine.

The state has no PRNG key: a ``torch.Generator`` comes with every call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import LockstepGraph
from adaptive_mcmc_tpu_torch.kernels.base import (
    Kernel,
    StepParts,
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
    Machine,
    build_fused_asss,
)
from adaptive_mcmc_tpu_torch.utils import profiling

Tensor = torch.Tensor

# shrinkage trips per block of the lockstep step: the step reads its active
# mask on the host once per block (on the card, once per CUDA graph replay
# of a block), not once per trip.  chip_smoke.py's trial on the H100 chose
# it: 4 is the fastest of 4, 8, 16, 32 on eight schools at 4096 chains and
# ties 8 on the figures' frozen rollouts at d = 1 (PERF.md §6)
SHRINK_TRIPS = 4


def _count(n: int) -> None:
    """Count the lockstep step's trips run, the masked ones of a block
    included (``asss.trips``)."""
    profiling.count("asss.trips", n)


@dataclasses.dataclass(frozen=True)
class ASSSConfig:
    lr_decay: float = 2.0 / 3.0
    eps: float = 1e-6
    max_shrinkage_iters: int = 50
    num_warmup: int = 0
    adapt: bool = True
    # step_n / collect_n in one launch of kernel K3.  None resolves to on
    # where a CUDA device is present and AMT_ASSS_FUSED=1, else off; the
    # built kernel's config holds the resolved value.  Its random streams
    # differ from the plain drivers': equal in distribution only.
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

    eps, max_iters = config.eps, config.max_shrinkage_iters

    def transformed_pe(z, loc, sig):
        x_flat = stereographic_inverse(z, loc, sig)
        return potential(x_flat) + d * torch.log(1.0 - z[:, -1])

    def is_bad(p, theta):
        z_theta = p["z"] * torch.cos(theta)[:, None] \
            + p["v"] * torch.sin(theta)[:, None]
        pe = nan_to_inf(transformed_pe(z_theta, p["s"].adapt_state.loc,
                                       p["sig"]))
        return (pe > p["t_pe"]) | ((1.0 - z_theta[:, -1]) < eps)

    def work(state: ASSSState) -> dict:
        """The step's dict: the state and the loop's tensors, zeroed."""
        C, dev = state.position.shape[0], state.position.device
        zero = torch.zeros(C, device=dev)
        return dict(s=state, sig=torch.zeros((C, d, d), device=dev),
                    z=torch.zeros((C, d + 1), device=dev),
                    v=torch.zeros((C, d + 1), device=dev), t_pe=zero,
                    theta=zero, tmin=zero, tmax=zero,
                    bad=torch.zeros(C, dtype=torch.bool, device=dev),
                    iters=torch.zeros(C, dtype=torch.int32, device=dev),
                    total=zero)

    def begin(p: dict, velocity, u_level, u_theta) -> dict:
        """Before the loop: the whitened projection, the tangent velocity,
        the slice level, the first angle and its test."""
        s = p["s"]
        loc, scale = s.adapt_state
        sig = (scale + eps * torch.eye(d, device=scale.device)) * (d ** 0.5)
        z = stereographic_project(s.position, loc, sig)
        pe_t = transformed_pe(z, loc, sig)
        v = velocity - torch.sum(velocity * z, dim=-1, keepdim=True) * z
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        theta = u_theta * TWO_PI
        q = dict(p, sig=sig, z=z, v=v, t_pe=pe_t - torch.log(u_level),
                 theta=theta, tmin=theta - TWO_PI, tmax=theta,
                 iters=torch.zeros_like(p["iters"]))
        q["bad"] = is_bad(q, theta)
        return q

    def active(p: dict) -> Tensor:
        return p["bad"] & (p["iters"] < max_iters)

    def trip(p: dict, u: Tensor) -> dict:
        """One trip of the great-circle shrinkage under the active mask:
        the bracket shrinks toward the rejected angle, a new angle is
        drawn in it and tested; a landed or bailed chain keeps all."""
        act = active(p)
        theta = p["theta"]
        tmin = torch.where(act & (theta < 0.0), theta, p["tmin"])
        tmax = torch.where(act & (theta >= 0.0), theta, p["tmax"])
        theta = torch.where(act, tmin + u * (tmax - tmin), theta)
        return dict(p, tmin=tmin, tmax=tmax, theta=theta,
                    iters=p["iters"] + act.to(torch.int32),
                    bad=torch.where(act, is_bad(p, theta), p["bad"]))

    def end(p: dict) -> dict:
        """After the loop: the bail-out to θ = 0, the inverse map, the
        potential and the guarded adaptation (K1); adds the step's trips
        to ``total``."""
        state, iters = p["s"], p["iters"]
        loc, scale = state.adapt_state
        theta = torch.where(iters >= max_iters,
                            torch.zeros_like(p["theta"]), p["theta"])
        z_new = p["z"] * torch.cos(theta)[:, None] \
            + p["v"] * torch.sin(theta)[:, None]
        x_new = stereographic_inverse(z_new, loc, p["sig"])
        pe_new = nan_to_inf(potential(x_new))
        if config.adapt:
            _, gamma = adaptation_lr(state.i, config.num_warmup,
                                     config.lr_decay)
            delta = x_new - loc
            loc_new = loc + gamma * delta
            scale_new = adaptive_scale_update(scale, delta,
                                              gamma.expand(x_new.shape[0]))
            as_change = torch.linalg.vector_norm(loc_new - loc, dim=-1) \
                + torch.linalg.matrix_norm(scale_new - scale)
            adapt_new = ASSSAdaptState(loc_new, scale_new)
        else:
            adapt_new = state.adapt_state
            as_change = torch.zeros_like(pe_new)
        new_state = ASSSState(i=state.i + 1, position=x_new,
                              potential_energy=pe_new,
                              adapt_state=adapt_new, as_change=as_change)
        return dict(p, s=new_state,
                    total=p["total"] + iters.to(torch.float32))

    def generator_draws(p: dict, generator) -> tuple:
        C, dev = p["s"].position.shape[0], p["s"].position.device
        return (torch.randn((C, d + 1), generator=generator, device=dev),
                torch.rand((C,), generator=generator, device=dev),
                torch.rand((C,), generator=generator, device=dev))

    def trip_draw(p: dict, generator) -> Tensor:
        return torch.rand((p["s"].position.shape[0],), generator=generator,
                          device=p["s"].position.device)

    parts = StepParts(
        work=work,
        begin=lambda p, g: begin(p, *generator_draws(p, g)),
        trip=lambda p, g: trip(p, trip_draw(p, g)),
        running=lambda p: torch.any(active(p)),
        end=end, block=lambda: SHRINK_TRIPS, count=_count)

    def _steps(state: ASSSState, n_steps: int, generator,
               draws: Optional[Sequence[ASSSDraws]]) -> dict:
        """``n_steps`` lockstep transitions in a Python loop over the same
        blocks of trips as the graph driver, with the same draws; the
        active mask is read on the host once per block.  Injected draws
        (one :class:`ASSSDraws` per step): a masked trip past the last row
        of ``u_shrink`` reads nothing, an active one raises."""
        if draws is None and generator is None:
            raise ValueError("a torch.Generator or injected draws are "
                             "needed")
        p = work(state)
        for t in range(n_steps):
            if draws is None:
                p = parts.begin(p, generator)
            else:
                dr = draws[t]
                p = begin(p, dr.velocity, dr.u_level, dr.u_theta)
                rows = dr.u_shrink.shape[0]
                blank = torch.zeros_like(p["theta"])
            k = 0
            while bool(parts.running(p)):
                for _ in range(SHRINK_TRIPS):
                    if draws is None:
                        p = parts.trip(p, generator)
                    else:
                        p = trip(p, dr.u_shrink[k] if k < rows else blank)
                    k += 1
                _count(SHRINK_TRIPS)
                if draws is not None and k > rows \
                        and int(p["iters"].max()) > rows:
                    raise ValueError(f"injected u_shrink has {rows} rows; "
                                     f"trip {rows} needs more")
            p = end(p)
        return p

    def step(state: ASSSState, generator: Optional[torch.Generator] = None,
             draws: Optional[ASSSDraws] = None) -> ASSSState:
        return _steps(state, 1, generator,
                      None if draws is None else [draws])["s"]

    def probe(state: ASSSState, n_steps: int,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Sequence[ASSSDraws]] = None, *,
              eager: bool = False):
        """Advance ``n_steps`` lockstep transitions exactly as ``step``
        does and return (final_state, per-chain MEAN shrinkage trips per
        transition); ``draws`` holds one :class:`ASSSDraws` per step.  On
        the card with a generator the steps replay from CUDA graphs
        (:class:`~adaptive_mcmc_tpu_torch.infer.mcmc.LockstepGraph`) unless
        ``eager``."""
        if draws is None and generator is not None and not eager \
                and state.position.is_cuda:
            p = LockstepGraph(parts, generator, "asss.probe").advance(
                state, n_steps)
        else:
            p = _steps(state, n_steps, generator, draws)
        return p["s"], p["total"] / float(n_steps)

    def _as_tuple(state: ASSSState):
        a = state.adapt_state
        return (state.position, state.potential_energy, a.loc, a.scale,
                state.i, state.as_change)

    use_fused = config.fused
    if use_fused is None:
        use_fused = torch.cuda.is_available() \
            and os.environ.get("AMT_ASSS_FUSED") == "1"
    if use_fused:
        fused_drive = build_fused_asss(target, config)

        def drive(state_tuple, n_steps, n_frames, thinning, generator,
                  eager):
            return fused_drive(state_tuple, n_steps, n_frames, thinning,
                               generator=generator)
    else:
        machine = Machine(target, config, adaptive_scale_update_cl)

        def drive(state_tuple, n_steps, n_frames, thinning, generator,
                  eager):
            return machine.run(state_tuple, n_steps, n_frames, thinning,
                               generator, eager=eager)[:2]

    def _run(state: ASSSState, n_steps: int, n_frames: int, thinning: int,
             generator, eager: bool):
        if generator is None:
            raise ValueError("step_n / collect_n need a torch.Generator")
        (x, pe, loc, scale, i, as_change), frames = drive(
            _as_tuple(state), n_steps, n_frames, thinning, generator, eager)
        new = ASSSState(i=i, position=x, potential_energy=pe,
                        adapt_state=ASSSAdaptState(loc, scale),
                        as_change=as_change)
        return new, frames

    def step_n(state: ASSSState, n_steps: int,
               generator: Optional[torch.Generator] = None, *,
               eager: bool = False) -> ASSSState:
        return _run(state, n_steps, 0, 1, generator, eager)[0]

    def collect_n(state: ASSSState, n_frames: int, thinning: int = 1,
                  generator: Optional[torch.Generator] = None, *,
                  eager: bool = False):
        return _run(state, n_frames * thinning, n_frames, thinning,
                    generator, eager)

    return Kernel(
        name="asss",
        target=target,
        config=dataclasses.replace(config, fused=bool(use_fused)),
        init=init,
        step=step,
        step_n=step_n,
        collect_n=collect_n,
        collect_fields=("position", "potential_energy", "as_change"),
        probe=probe,
        step_parts=parts,
    )
