"""ARWMH — Adaptive Random-Walk Metropolis-Hastings (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/kernels/arwmh.py``, with the same
recursion:

  * proposal  x' = x + (L e^λ + ε I) @ N(0, I_d)
  * NaN potential -> +inf; MH accept α = min(1, exp(U - U'))
  * adaptation clock n resets at the warmup boundary
  * γ = n^(-lr_decay); μ' = μ + γδ;
    L' = chol((1-γ) L Lᵀ + γ δδᵀ) with a per-chain NaN guard
  * log λ' = log λ + γ(α − α*)
  * as_change = ‖L' e^{λ'} − L e^{λ}‖_F

The state is a batch of ``(C, ...)`` tensors.  The lockstep ``step`` takes
its draws from a ``torch.Generator`` or, for replay, from injected
``noise`` (C, d) and ``unif`` (C,).  The rank-1 update goes through kernel
K1 (``ops/cholesky.py``).  ``ARWMHConfig(fused=True)`` adds ``step_n`` and
``collect_n`` that run whole sweeps in kernel K2
(``ops/cuda/arwmh_fused.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from adaptive_mcmc_tpu_torch.kernels.base import (
    Kernel,
    adaptation_lr,
    batch_positions,
    nan_to_inf,
)
from adaptive_mcmc_tpu_torch.ops.cholesky import adaptive_scale_update
from adaptive_mcmc_tpu_torch.ops.cuda.arwmh_fused import build_fused_arwmh

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ARWMHConfig:
    lr_decay: float = 2.0 / 3.0
    target_accept_prob: float = 0.234
    eps: float = 1e-6
    num_warmup: int = 0
    adapt: bool = True          # False freezes loc/scale/step-size (plain RWM
                                # with a fixed Cholesky proposal)
    # Fused whole-sweep driver (kernel K2): step_n / collect_n run the
    # transition loop in one launch.  None resolves to off.  Its random
    # streams differ from the lockstep step's: equal in distribution only.
    fused: Optional[bool] = None


class ARWMHAdaptState(NamedTuple):
    loc: Tensor            # (C, d)   running mean μ̂
    scale: Tensor          # (C, d, d) Cholesky factor Σ̂^{1/2} (lower)
    log_step_size: Tensor  # (C,)     log λ


class ARWMHState(NamedTuple):
    i: Tensor                  # 0-d int32 iteration (lockstep across chains)
    position: Tensor           # (C, d) current point, unconstrained
    potential_energy: Tensor   # (C,)
    mean_accept_prob: Tensor   # (C,) running mean of acceptance probabilities
    adapt_state: ARWMHAdaptState
    as_change: Tensor          # (C,) ‖Δ(L e^λ)‖_F adaptation-drift diagnostic


def _draws(generator, C: int, d: int, device, noise, unif):
    if noise is not None:
        if unif is None:
            raise ValueError("pass both noise and unif, or neither")
        return noise, unif
    if generator is None:
        raise ValueError("a torch.Generator or injected draws are needed")
    noise = torch.randn((C, d), generator=generator, device=device)
    unif = torch.rand((C,), generator=generator, device=device)
    return noise, unif


def arwmh(target, config: ARWMHConfig = ARWMHConfig()) -> Kernel:
    d = target.dim
    potential = target.potential_fn

    def init(generator: Optional[torch.Generator] = None, n_chains: int = 1,
             position=None, adapt_state: Optional[ARWMHAdaptState] = None,
             device=None) -> ARWMHState:
        pos = batch_positions(target, generator, n_chains, position, device)
        dev = pos.device
        pe = nan_to_inf(potential(pos))
        if adapt_state is None:
            adapt_state = ARWMHAdaptState(
                loc=pos.clone(),
                scale=torch.eye(d, device=dev).expand(n_chains, d, d)
                .contiguous(),
                log_step_size=torch.zeros(n_chains, device=dev),
            )
        return ARWMHState(
            i=torch.zeros((), dtype=torch.int32, device=dev),
            position=pos,
            potential_energy=pe,
            mean_accept_prob=torch.zeros(n_chains, device=dev),
            adapt_state=adapt_state,
            as_change=torch.zeros(n_chains, device=dev),
        )

    def step(state: ARWMHState, generator: Optional[torch.Generator] = None,
             noise: Optional[Tensor] = None,
             unif: Optional[Tensor] = None) -> ARWMHState:
        loc, L, log_lam = state.adapt_state
        x, pe = state.position, state.potential_energy
        C = x.shape[0]
        noise, u = _draws(generator, C, d, x.device, noise, unif)

        step_size = torch.exp(log_lam)  # (C,)
        prop_scale = L * step_size[:, None, None] \
            + config.eps * torch.eye(d, device=x.device)
        x_prop = x + torch.einsum("cij,cj->ci", prop_scale, noise)

        pe_prop = nan_to_inf(potential(x_prop))
        accept_prob = torch.exp(pe - pe_prop).clamp_max(1.0)
        accepted = u < accept_prob

        x_new = torch.where(accepted[:, None], x_prop, x)
        pe_new = torch.where(accepted, pe_prop, pe)

        n, gamma = adaptation_lr(state.i, config.num_warmup, config.lr_decay)
        mean_ap = state.mean_accept_prob
        mean_ap_new = mean_ap + (accept_prob - mean_ap) / n.to(torch.float32)

        if config.adapt:
            delta = x_new - loc
            loc_new = loc + gamma * delta
            L_new = adaptive_scale_update(L, delta, gamma.expand(C))
            log_lam_new = log_lam + gamma * (
                accept_prob - config.target_accept_prob
            )
            as_change = torch.linalg.matrix_norm(
                L_new * torch.exp(log_lam_new)[:, None, None]
                - L * step_size[:, None, None]
            )
            adapt_new = ARWMHAdaptState(loc_new, L_new, log_lam_new)
        else:
            adapt_new = state.adapt_state
            as_change = torch.zeros_like(pe)

        return ARWMHState(
            i=state.i + 1,
            position=x_new,
            potential_energy=pe_new,
            mean_accept_prob=mean_ap_new,
            adapt_state=adapt_new,
            as_change=as_change,
        )

    step_n = collect_n = None
    if config.fused:
        if not config.adapt:
            raise ValueError("the fused ARWMH driver always adapts; "
                             "use fused=False with adapt=False")
        drive = build_fused_arwmh(target, config)

        def _as_tuple(state: ARWMHState):
            a = state.adapt_state
            return (state.position, state.potential_energy,
                    state.mean_accept_prob, a.loc, a.scale,
                    a.log_step_size, state.i)

        def _from_tuple(new) -> ARWMHState:
            return ARWMHState(
                i=new[6],
                position=new[0],
                potential_energy=new[1],
                mean_accept_prob=new[2],
                adapt_state=ARWMHAdaptState(new[3], new[4], new[5]),
                as_change=new[7],
            )

        def step_n(state: ARWMHState, n_steps: int, generator=None,
                   noise=None, unif=None, *, eager: bool = False
                   ) -> ARWMHState:
            new, _ = drive(_as_tuple(state), n_steps, 0, 1,
                           generator=generator, noise=noise, unif=unif)
            return _from_tuple(new)

        def collect_n(state: ARWMHState, n_frames: int, thinning: int = 1,
                      generator=None, noise=None, unif=None, *,
                      eager: bool = False):
            new, frames = drive(_as_tuple(state), n_frames * thinning,
                                n_frames, thinning, generator=generator,
                                noise=noise, unif=unif)
            return _from_tuple(new), frames

    return Kernel(
        name="arwmh",
        target=target,
        config=config,
        init=init,
        step=step,
        step_n=step_n,
        collect_n=collect_n,
        collect_fields=(
            ("position", "potential_energy", "as_change")
            if config.fused else ()
        ),
        # the step reads nothing on the host: state.i and the adaptation
        # clock are device tensors
        graph_step=True,
    )


def rwm(target, scale: Optional[Tensor] = None, step_size: float = 1.0,
        eps: float = 1e-6) -> Kernel:
    """Fixed-proposal random-walk Metropolis: ARWMH with adaptation frozen.
    ``scale`` is the fixed Cholesky proposal factor (default I)."""
    k = arwmh(target, ARWMHConfig(adapt=False, eps=eps))
    d = target.dim

    def init(generator=None, n_chains=1, position=None, adapt_state=None,
             device=None):
        st = k.init(generator, n_chains, position, device=device)
        if adapt_state is None:
            dev = st.position.device
            L = torch.eye(d, device=dev) if scale is None else \
                torch.as_tensor(scale, dtype=torch.float32, device=dev)
            adapt_state = ARWMHAdaptState(
                loc=st.adapt_state.loc,
                scale=L.expand(n_chains, d, d).contiguous(),
                log_step_size=torch.full(
                    (n_chains,), float(torch.log(torch.tensor(step_size))),
                    device=dev,
                ),
            )
        return st._replace(adapt_state=adapt_state)

    return dataclasses.replace(k, name="rwm", init=init)
