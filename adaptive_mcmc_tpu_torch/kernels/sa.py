"""SA — Sample-Adaptive MCMC (Zhu 2019) (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/kernels/sa.py``, with the same
recursion.  SA keeps an ensemble of N points S = {z_1..z_N} per chain;
proposes w ~ N(mean(S), cov(S)); among the N+1 points S ∪ {w} deletes one
index J drawn with probability

    p_j ∝ φ(z_j | λ(S ∪ {w} \\ {z_j})) / π(z_j)

(φ the Gaussian family, λ(·) its mean and covariance fitted to the set).
Deleting J = N+1 rejects the proposal.  The reported sample is a uniformly
random member of the ensemble.

Replace-z_i-by-w covariance identity (m = mean(S), C = cov(S), biased 1/N;
δ = (w − z_i)/N):

    C_i = C + (w−m)(w−m)ᵀ/N − (z_i−m)(z_i−m)ᵀ/N − δδᵀ
    m_i = m + δ

so each leave-one-out factor is three chained rank-1 Cholesky updates.
They go through kernel K1's chains-first entry
(``ops/cholesky.rank1_cholesky_update_batched``).  The first update,
``rank1(scale, w − m, 1/N)``, does not depend on z_i: it runs once per
chain at (C, d, d) and is expanded over the N candidates (K1 computes each
chain alone, so this gives the bits of N separate updates); the next two
run at (C·N, d, d).  Three K1 launches per step; the diagonal variant
(``dense_mass=False``) is elementwise and launches none.

The categorical deletion draw is the Gumbel-max argmax that
``jax.random.categorical`` computes: ``argmax(log_ws + gumbel)``.  NaN
semantics follow JAX: a NaN ``log_phi`` becomes −inf, ``−inf + inf`` in
``log_ws`` is NaN, and argmax picks the first NaN (else the first maximum).
The per-chain NaN guard refits (loc, scale) from the new ensemble for every
chain on every step (``cholesky_ex``, NaN where the covariance is not
positive definite) and selects with ``torch.where``: the step reads nothing
on the host, so ``run_mcmc`` replays it from a CUDA graph on the card.

The state has no PRNG key: draws come from a ``torch.Generator`` per call
or, for replay, from :class:`SADraws`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from adaptive_mcmc_tpu_torch.kernels.base import (
    Kernel,
    batch_positions,
    nan_to_inf,
)
from adaptive_mcmc_tpu_torch.ops.cholesky import (
    rank1_cholesky_update_batched,
)

Tensor = torch.Tensor
_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class SAConfig:
    adapt_state_size: Optional[int] = None  # None -> max(102, 2*dim) as in
                                            # NumPyro's default sizing
    dense_mass: bool = True
    num_warmup: int = 0                     # SA adapts continuously; kept
                                            # for driver uniformity
    init_spread: float = 1.0


class SAAdaptState(NamedTuple):
    zs: Tensor      # (C, N, d) ensemble
    pes: Tensor     # (C, N) potential energies
    loc: Tensor     # (C, d) ensemble mean
    scale: Tensor   # (C, d, d) chol(cov) dense | (C, d) std diag


class SAState(NamedTuple):
    i: Tensor                  # 0-d int32 iteration
    position: Tensor           # (C, d)
    potential_energy: Tensor   # (C,)
    accept_prob: Tensor        # (C,)
    mean_accept_prob: Tensor   # (C,)
    diverging: Tensor          # (C,) bool, always False
    adapt_state: SAAdaptState


class SADraws(NamedTuple):
    """One step's draws for every chain: the proposal's normals, the Gumbel
    noise of the deletion draw, and the index of the reported member."""

    eps: Tensor      # (C, d)
    gumbel: Tensor   # (C, N + 1)
    pick: Tensor     # (C,) int64 in [0, N)


def ensemble_stats(zs: Tensor, dense_mass: bool) -> tuple:
    """(loc, scale) of ensembles ``zs`` (C, N, d): the mean and the Cholesky
    factor of the biased covariance plus 1e-6 I (NaN where that is not
    positive definite), or the per-coordinate standard deviation."""
    N, d = zs.shape[-2:]
    loc = torch.mean(zs, dim=-2)
    centered = zs - loc[..., None, :]
    if dense_mass:
        cov = (centered.transpose(-1, -2) @ centered) * (1.0 / N) \
            + 1e-6 * torch.eye(d, device=zs.device)
        L, info = torch.linalg.cholesky_ex(cov)
        return loc, torch.where((info > 0)[..., None, None],
                                torch.full_like(L, float("nan")), L)
    return loc, torch.sqrt(torch.mean(centered**2, dim=-2) + 1e-6)


def replace_stats(loc: Tensor, scale: Tensor, zs: Tensor, w: Tensor,
                  dense_mass: bool) -> tuple:
    """λ of each chain's ensemble with z_i replaced by w, for every i:
    ``loc`` (C, d), ``scale`` (C, d, d) or (C, d), ``zs`` (C, N, d), ``w``
    (C, d) -> (C, N, d) locs and (C, N, d, d) or (C, N, d) scales."""
    C, N, d = zs.shape
    inv_n = 1.0 / N
    delta = (w[:, None, :] - zs) * inv_n
    locs = loc[:, None, :] + delta
    if not dense_mass:
        var = scale[:, None, :]**2 + inv_n * (
            (w - loc)[:, None, :] ** 2 - (zs - loc[:, None, :]) ** 2
        ) - delta**2
        return locs, torch.sqrt(torch.clamp_min(var, 1e-12))
    # coefficients made on the device: a Python number would be copied
    # from the host, which a CUDA graph capture refuses
    def coef(n: int, value: float) -> Tensor:
        return torch.full((n,), value, device=zs.device)

    s = rank1_cholesky_update_batched(scale, w - loc, coef(C, inv_n))
    s = s[:, None].expand(C, N, d, d).reshape(C * N, d, d)
    s = rank1_cholesky_update_batched(
        s, (zs - loc[:, None, :]).reshape(C * N, d), coef(C * N, -inv_n))
    s = rank1_cholesky_update_batched(s, delta.reshape(C * N, d),
                                      coef(C * N, -1.0))
    return locs, s.reshape(C, N, d, d)


def _mvn_logpdf_dense(x: Tensor, loc: Tensor, chol: Tensor) -> Tensor:
    d = x.shape[-1]
    y = torch.linalg.solve_triangular(chol, (x - loc)[..., None],
                                      upper=False)[..., 0]
    return (
        -0.5 * torch.sum(y * y, dim=-1)
        - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                    dim=-1)
        - 0.5 * d * _LOG_2PI
    )


def _norm_logpdf_diag(x: Tensor, loc: Tensor, std: Tensor) -> Tensor:
    z = (x - loc) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * _LOG_2PI, dim=-1)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[c, idx[c]]`` for every chain c (a gather, no host read)."""
    index = idx.view((-1,) + (1,) * (x.dim() - 1)).expand(
        (x.shape[0], 1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, index)[:, 0]


def sa(target, config: SAConfig = SAConfig()) -> Kernel:
    d = target.dim
    N = config.adapt_state_size or max(102, 2 * d)
    potential = target.potential_fn
    dense = config.dense_mass

    def init(generator: Optional[torch.Generator] = None, n_chains: int = 1,
             position=None, adapt_state: Optional[SAAdaptState] = None,
             device=None) -> SAState:
        pos = batch_positions(target, generator, n_chains, position, device)
        dev = pos.device
        pe = nan_to_inf(potential(pos))
        if adapt_state is None:
            noise = torch.randn((n_chains, N, d), generator=generator,
                                device=dev)
            zs = pos[:, None, :] + config.init_spread * noise
            pes = nan_to_inf(
                potential(zs.reshape(n_chains * N, d)).reshape(n_chains, N))
            loc, scale = ensemble_stats(zs, dense)
            adapt_state = SAAdaptState(zs, pes, loc, scale)
        return SAState(
            i=torch.zeros((), dtype=torch.int32, device=dev),
            position=pos,
            potential_energy=pe,
            accept_prob=torch.zeros(n_chains, device=dev),
            mean_accept_prob=torch.zeros(n_chains, device=dev),
            diverging=torch.zeros(n_chains, dtype=torch.bool, device=dev),
            adapt_state=adapt_state,
        )

    def _draws(generator, C: int, device) -> SADraws:
        if generator is None:
            raise ValueError("a torch.Generator or injected draws are needed")
        eps = torch.randn((C, d), generator=generator, device=device)
        u = torch.rand((C, N + 1), generator=generator, device=device)
        # jax.random.gumbel: -log(-log(u)), u uniform on [tiny, 1)
        u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
        pick = torch.randint(0, N, (C,), generator=generator, device=device)
        return SADraws(eps, -torch.log(-torch.log(u)), pick)

    def step(state: SAState, generator: Optional[torch.Generator] = None,
             draws: Optional[SADraws] = None) -> SAState:
        zs, pes, loc, scale = state.adapt_state
        C = zs.shape[0]
        if draws is None:
            draws = _draws(generator, C, zs.device)
        eps, gumbel, pick = draws

        if dense:
            w = loc + torch.einsum("cij,cj->ci", scale, eps)
        else:
            w = loc + scale * eps
        pe_w = nan_to_inf(potential(w))

        locs_r, scales_r = replace_stats(loc, scale, zs, w, dense)
        logpdf = _mvn_logpdf_dense if dense else _norm_logpdf_diag
        log_phi = logpdf(zs, locs_r, scales_r)               # (C, N)
        log_phi_w = logpdf(w, loc, scale)                    # (C,)
        # numerically degenerate leave-one-out factors can't win
        log_phi = torch.where(torch.isnan(log_phi),
                              torch.full_like(log_phi, float("-inf")),
                              log_phi)

        # deletion weights: phi / pi = exp(log_phi + pe)
        log_ws = torch.cat([log_phi + pes, (log_phi_w + pe_w)[:, None]], 1)
        j = torch.argmax(gumbel + log_ws, dim=1)
        accept_prob = 1.0 - torch.softmax(log_ws, dim=1)[:, N]

        replaced = j < N
        j_safe = torch.clamp_max(j, N - 1)
        deleted = torch.arange(N, device=zs.device) == j[:, None]  # (C, N)
        zs_new = torch.where(deleted[:, :, None], w[:, None, :], zs)
        pes_new = torch.where(deleted, pe_w[:, None], pes)
        loc_new = torch.where(replaced[:, None], _take(locs_r, j_safe), loc)
        scale_new = torch.where(
            replaced.view((C,) + (1,) * (scale.dim() - 1)),
            _take(scales_r, j_safe), scale)
        # NaN guard on the incremental factor: refit from scratch, computed
        # for every chain and selected per chain, as JAX's where does
        if dense:
            bad = torch.isnan(scale_new).flatten(1).any(dim=1)
            loc_f, scale_f = ensemble_stats(zs_new, True)
            loc_new = torch.where(bad[:, None], loc_f, loc_new)
            scale_new = torch.where(bad[:, None, None], scale_f, scale_new)

        itr = state.i + 1
        n = torch.where(state.i < config.num_warmup, itr,
                        itr - config.num_warmup).to(torch.float32)
        mean_ap = state.mean_accept_prob
        return SAState(
            i=itr,
            # reported sample: a uniformly random ensemble member
            position=_take(zs_new, pick),
            potential_energy=_take(pes_new, pick),
            accept_prob=accept_prob,
            mean_accept_prob=mean_ap + (accept_prob - mean_ap) / n,
            diverging=torch.zeros_like(state.diverging),
            adapt_state=SAAdaptState(zs_new, pes_new, loc_new, scale_new),
        )

    return Kernel(
        name="sa",
        target=target,
        config=config,
        init=init,
        step=step,
        # the step reads nothing on the host: the deletion draw, the
        # replacement and the NaN guard are selects and gathers
        graph_step=True,
    )
