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
``noise`` (C, d) and ``unif`` (C,).  Around the target's potential it runs
three steps, :func:`propose_plain`, :func:`accept_plain` and
:func:`settle_plain`, with the rank-1 update through kernel K1
(``ops/cuda/chol_update.py``) between the last two; on a CUDA state each of
the three is a kernel of ``ops/cuda/arwmh_step.py``, which repeats its
operations (the proposal's sum in an order of its own, as_change's too).
``ARWMHConfig(fused=True)`` adds ``step_n`` and ``collect_n`` that run whole
sweeps in kernel K2 (``ops/cuda/arwmh_fused.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch

from adaptive_mcmc_tpu_torch.kernels.base import (
    Kernel,
    adaptation_lr,
    batch_positions,
    nan_to_inf,
)
from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_step
from adaptive_mcmc_tpu_torch.ops.cuda.arwmh_fused import build_fused_arwmh
from adaptive_mcmc_tpu_torch.ops.cuda.arwmh_step import Accepted
from adaptive_mcmc_tpu_torch.ops.cuda.chol_update import chol_update

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
    # transition loop in one launch.  None resolves to on where a CUDA
    # device is present, the sampler adapts, d <= 16 and AMT_ARWMH_FUSED=1
    # (the JAX package's opt-in), else off; the built kernel's config holds
    # the resolved value.  Its random streams differ from the lockstep
    # step's: equal in distribution only.
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


def propose_plain(x: Tensor, L: Tensor, log_lam: Tensor, noise: Tensor,
                  eps: float) -> Tensor:
    """The proposal ``x + (L e^λ + ε I) z``: the plain version of
    ``ops/cuda/arwmh_step.propose``."""
    prop_scale = L * torch.exp(log_lam)[:, None, None] \
        + eps * torch.eye(x.shape[1], device=x.device)
    return x + torch.einsum("cij,cj->ci", prop_scale, noise)


def accept_plain(x, pe, x_prop, pe_prop, u, mean_ap, i, loc, L, log_lam, *,
                 num_warmup: int, lr_decay: float, target_accept_prob: float,
                 adapt: bool) -> Accepted:
    """The MH select, the running mean of acceptance and the adaptation up
    to K1's inputs: the plain version of ``ops/cuda/arwmh_step.accept``."""
    pe_prop = nan_to_inf(pe_prop)
    accept_prob = torch.exp(pe - pe_prop).clamp_max(1.0)
    accepted = u < accept_prob
    x_new = torch.where(accepted[:, None], x_prop, x)
    pe_new = torch.where(accepted, pe_prop, pe)
    n, gamma = adaptation_lr(i, num_warmup, lr_decay)
    mean_new = mean_ap + (accept_prob - mean_ap) / n.to(torch.float32)
    if not adapt:
        return Accepted(x_new, pe_new, mean_new)
    delta = x_new - loc
    coef = gamma.expand(x.shape[0])
    return Accepted(
        x_new, pe_new, mean_new,
        loc=loc + gamma * delta,
        log_step_size=log_lam + gamma * (accept_prob - target_accept_prob),
        scaled=torch.sqrt(1.0 - coef)[:, None, None] * L,
        delta=delta,
        gamma=coef.contiguous(),
    )


def settle_plain(L: Tensor, updated: Tensor, log_lam: Tensor,
                 log_lam_new: Tensor, i: Tensor) -> tuple:
    """``(L', as_change, i + 1)``: the per-chain NaN guard on K1's result,
    ``‖L' e^{λ'} − L e^λ‖_F`` and the clock; the plain version of
    ``ops/cuda/arwmh_step.settle``."""
    bad = torch.isnan(updated).any(dim=-1).any(dim=-1)
    L_new = torch.where(bad[:, None, None], L, updated)
    as_change = torch.linalg.matrix_norm(
        L_new * torch.exp(log_lam_new)[:, None, None]
        - L * torch.exp(log_lam)[:, None, None])
    return L_new, as_change, i + 1


# the step's operations around the potential, by where the state lives: the
# kernels of csrc/arwmh_step.cu on the card, their plain versions elsewhere
_PLAIN = (propose_plain, accept_plain, settle_plain)
_CARD = (arwmh_step.propose, arwmh_step.accept, arwmh_step.settle)


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
        noise, u = _draws(generator, x.shape[0], d, x.device, noise, unif)
        propose, accept, settle = _CARD if x.is_cuda else _PLAIN
        x_prop = propose(x, L, log_lam, noise, config.eps)
        new = accept(x, pe, x_prop, potential(x_prop), u,
                     state.mean_accept_prob, state.i, loc, L, log_lam,
                     num_warmup=config.num_warmup, lr_decay=config.lr_decay,
                     target_accept_prob=config.target_accept_prob,
                     adapt=config.adapt)
        if config.adapt:
            L_new, as_change, i_new = settle(
                L, chol_update(new.scaled, new.delta, new.gamma), log_lam,
                new.log_step_size, state.i)
            adapt_new = ARWMHAdaptState(new.loc, L_new, new.log_step_size)
        else:
            adapt_new, as_change, i_new = (state.adapt_state,
                                           torch.zeros_like(pe), state.i + 1)
        return ARWMHState(
            i=i_new,
            position=new.position,
            potential_energy=new.potential_energy,
            mean_accept_prob=new.mean_accept_prob,
            adapt_state=adapt_new,
            as_change=as_change,
        )

    use_fused = config.fused
    if use_fused is None:
        use_fused = torch.cuda.is_available() and config.adapt and d <= 16 \
            and os.environ.get("AMT_ARWMH_FUSED") == "1"
    step_n = collect_n = None
    if use_fused:
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
        config=dataclasses.replace(config, fused=bool(use_fused)),
        init=init,
        step=step,
        step_n=step_n,
        collect_n=collect_n,
        collect_fields=(
            ("position", "potential_energy", "as_change")
            if use_fused else ()
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
