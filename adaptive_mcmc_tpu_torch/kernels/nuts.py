"""NUTS — the No-U-Turn Sampler, chain-batched (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/kernels/nuts.py``, with the same
transition: leapfrog integration under a diagonal or dense mass matrix,
multinomial sampling over the trajectory with biased subtree acceptance,
the iterative tree with its checkpoint stack of depth ``max_tree_depth``
(one balanced-subtree U-turn check per closing subtree), divergence at
``max_delta_energy``, and warmup adaptation: dual-averaging step size,
Welford covariance in Stan's 75 / 25-doubling / 50 windows, the dual
averaging restarted from the current step size at each window's end.
Gradients come from autograd over the batched ``potential_fn``.

Two drivers:

* ``step`` — one lockstep transition for all chains, the reference
  semantics: JAX vmaps a ``while_loop`` over doublings and one over
  leaves; here both are Python loops over all chains in which a finished
  chain's tree or subtree is left untouched (masked).  The loop conditions
  are read on the host, so the step cannot be captured
  (``Kernel.graph_step`` is False).  Its draws come from a
  ``torch.Generator`` or, for replay, from :class:`NUTSDraws`.
* ``step_n`` / ``collect_n`` — the pipelined machine: each trip runs one
  batched leapfrog, every chain drives its own tree, and a chain that
  finishes a transition opens its next one at once.  Each trip draws one
  uniform block ``(3 + d, C)``: ``u_acc``, ``u_bias``, the direction
  ``u < 0.5`` and ``d`` normals ``√2·erfinv(max(2u − 1, −0.99999994))``
  (JAX's ``_trip_draws``), so injected JAX uniforms replay a JAX run.
  Trips run in blocks of ``GRAPH_TRIPS``; ``done`` is read on the host
  between blocks.  On the card a block is captured into a CUDA graph and
  replayed (``infer.mcmc.BlockMachine``; ``step_n`` keeps its graph for
  the next call, ``collect_n`` captures its own); ``eager=True`` runs the same
  blocks in Python, with the same draws.  Trips past a chain's last
  transition are no-ops for it and still draw.  ``collect_n`` writes each
  chain's every ``thinning``-th position as the chain completes it, so it
  equals ``step_n`` bit for bit.

Three pieces of the JAX machine were TPU workarounds and are not ported:
the chains-last layout (the port keeps every leaf chains first, ``(C, d)``
and ``(C, max_depth, d)``, the layout the targets and autograd take), the
ring recorder with its freezing of chains that drift ahead (frames are
written directly), and unrolling (``unroll_leaves`` and
``pipeline_unroll`` are kept in :class:`NUTSConfig` so that configs carry
across, and do nothing here: the lockstep step runs one leaf per pass, the
machine one leapfrog per trip).  The window-close ``lax.cond`` of the
machine is an unconditional finalize and a select.

The state has no PRNG key: a ``torch.Generator`` comes with every call.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import BlockMachine
from adaptive_mcmc_tpu_torch.kernels.base import (
    Kernel,
    batch_positions,
    nan_to_inf,
)
from adaptive_mcmc_tpu_torch.utils import profiling

Tensor = torch.Tensor

# machine trips per block: one CUDA graph replay, one host read of `done`
GRAPH_TRIPS = 32
_SQRT2 = 1.4142135623730951
_U_LO = -0.99999994  # nextafter(-1, 0) in float32: keeps erfinv finite
_LOG_10 = math.log(10.0)


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    step_size: float = 1.0
    adapt_step_size: bool = True
    adapt_mass_matrix: bool = True
    dense_mass: bool = False
    target_accept_prob: float = 0.8
    max_tree_depth: int = 10
    num_warmup: int = 0
    max_delta_energy: float = 1000.0
    # JAX: leapfrogs per while trip of the lockstep subtree loop.  The
    # port's lockstep step runs one leaf per pass; kept for configs only.
    unroll_leaves: int = 4
    # expose the pipelined drivers step_n / collect_n
    pipeline: bool = True
    # JAX: leapfrogs per while trip of step_n.  The port's machine runs one
    # leapfrog per trip and GRAPH_TRIPS trips per block; kept for configs.
    pipeline_unroll: int = 2


class DAState(NamedTuple):
    """Dual-averaging step-size adaptation (per chain)."""

    t: Tensor
    log_eps: Tensor
    log_eps_avg: Tensor
    h_bar: Tensor
    mu: Tensor


class WelfordState(NamedTuple):
    count: Tensor   # (C,)
    mean: Tensor    # (C, d)
    m2: Tensor      # (C, d) diag or (C, d, d) dense


class NUTSAdaptState(NamedTuple):
    da: DAState
    inv_mass: Tensor        # (C, d) diag or (C, d, d) dense (M^-1)
    chol_inv_mass: Tensor   # (C, d) sqrt-diag or (C, d, d) lower chol of M^-1
    welford: WelfordState


class NUTSState(NamedTuple):
    i: Tensor                 # 0-d int32 iteration
    position: Tensor          # (C, d)
    potential_energy: Tensor  # (C,)
    pe_grad: Tensor           # (C, d) cached gradient
    mean_accept_prob: Tensor  # (C,)
    num_steps: Tensor         # (C,) int32 leapfrogs of the last transition
    diverging: Tensor         # (C,) bool
    adapt_state: NUTSAdaptState


class NUTSDraws(NamedTuple):
    """One lockstep transition's draws for every chain: the momentum's
    standard normals, per doubling the direction (right where u < 0.5) and
    the biased-merge uniform, per doubling and leaf the multinomial
    uniform (leaf n of the subtree at depth k reads ``u_leaf[:, k, n]``)."""

    momentum: Tensor  # (C, d)
    u_dir: Tensor     # (C, max_depth)
    u_bias: Tensor    # (C, max_depth)
    u_leaf: Tensor    # (C, max_depth, 2^(max_depth - 1))


# ---------------------------------------------------------------------------
# Mass-matrix algebra, batched over a leading chain axis: inv_mass (C, d)
# diag or (C, d, d) dense, momenta (C, d).
# ---------------------------------------------------------------------------

def _velocity(inv_mass: Tensor, r: Tensor) -> Tensor:
    """v = M^-1 r."""
    if inv_mass.dim() == 2:
        return inv_mass * r
    return torch.einsum("cij,cj->ci", inv_mass, r)


def _kinetic(inv_mass: Tensor, r: Tensor) -> Tensor:
    return 0.5 * torch.sum(r * _velocity(inv_mass, r), dim=-1)


def _sample_momentum(eps: Tensor, chol_inv_mass: Tensor) -> Tensor:
    """r ~ N(0, M) from standard normals ``eps`` (C, d).  With C = chol(M^-1)
    (lower), M = C^-T C^-1, so r = C^-T eps."""
    if chol_inv_mass.dim() == 2:
        return eps / chol_inv_mass
    return torch.linalg.solve_triangular(
        chol_inv_mass.transpose(-1, -2), eps[..., None], upper=True)[..., 0]


def _is_turning(inv_mass, r_first, r_last, rho) -> Tensor:
    v_first = _velocity(inv_mass, r_first)
    v_last = _velocity(inv_mass, r_last)
    return (torch.sum(v_first * rho, -1) <= 0.0) \
        | (torch.sum(v_last * rho, -1) <= 0.0)


def _velocity_rows(inv_mass: Tensor, R: Tensor) -> Tensor:
    """v_k = M^-1 r_k for stacks of momenta R (C, k, d)."""
    if inv_mass.dim() == 2:
        return inv_mass[:, None, :] * R
    return R @ inv_mass  # M^-1 is symmetric


# ---------------------------------------------------------------------------
# Warmup schedule (Stan's 75 / 25-doubling / 50 windows) and the checkpoint
# tables.
# ---------------------------------------------------------------------------

def build_warmup_schedule(num_warmup: int) -> tuple:
    """Bool tensors (length max(num_warmup, 1)): whether the Welford
    accumulator consumes iteration i, and whether a mass-matrix window
    closes at i."""
    in_window = np.zeros(max(num_warmup, 1), bool)
    window_end = np.zeros(max(num_warmup, 1), bool)
    if num_warmup >= 20:
        init, term, base = 75, 50, 25
        if init + base + term > num_warmup:
            init = int(0.15 * num_warmup)
            term = int(0.10 * num_warmup)
            base = num_warmup - init - term
        start, w = init, base
        while start < num_warmup - term:
            end = min(start + w, num_warmup - term)
            if num_warmup - term - end < w * 2:
                end = num_warmup - term  # absorb the remainder
            in_window[start:end] = True
            window_end[end - 1] = True
            start, w = end, w * 2
    return torch.from_numpy(in_window), torch.from_numpy(window_end)


def checkpoint_tables(max_depth: int) -> tuple:
    """(slot, trail) over leaf indices n < 2^max_depth: the checkpoint slot
    popcount(n >> 1) and the trailing ones of n (int64)."""
    n_tab = 1 << max_depth
    slot = torch.tensor([bin(i >> 1).count("1") for i in range(n_tab)])
    trail = torch.tensor([(i ^ (i + 1)).bit_length() - 1
                          for i in range(n_tab)])
    return slot, trail


def _sel(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """Per-chain select; ``mask`` (C,) broadcasts over trailing dims."""
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _sel_tree(mask, new, old):
    return type(old)(*(_sel(mask, n, o) for n, o in zip(new, old)))


class _LockstepDraws:
    """The lockstep transition's draws: injected :class:`NUTSDraws`, or
    drawn from ``generator`` as they are used."""

    def __init__(self, draws: Optional[NUTSDraws], generator, C: int, d: int,
                 device):
        if draws is None and generator is None:
            raise ValueError("a torch.Generator or injected draws are needed")
        self.draws, self.g, self.C, self.d, self.dev = \
            draws, generator, C, d, device

    def _rand(self):
        return torch.rand(self.C, generator=self.g, device=self.dev)

    def momentum(self) -> Tensor:
        if self.draws is not None:
            return self.draws.momentum
        return torch.randn((self.C, self.d), generator=self.g,
                           device=self.dev)

    def direction(self, depth: int) -> Tensor:
        return self._rand() if self.draws is None \
            else self.draws.u_dir[:, depth]

    def bias(self, depth: int) -> Tensor:
        return self._rand() if self.draws is None \
            else self.draws.u_bias[:, depth]

    def leaf(self, depth: int, n: int) -> Tensor:
        return self._rand() if self.draws is None \
            else self.draws.u_leaf[:, depth, n]


def _count(n: int) -> None:
    """Count the machine's trips run (``nuts.trips``): each block adds its
    length, a replay included."""
    profiling.count("nuts.trips", n)


def nuts(target, config: NUTSConfig = NUTSConfig()) -> Kernel:
    d = target.dim
    max_depth = config.max_tree_depth
    max_delta = config.max_delta_energy
    dense = config.dense_mass
    num_warmup = config.num_warmup
    do_adapt = num_warmup > 0 and (config.adapt_step_size
                                   or config.adapt_mass_matrix)
    in_window_cpu, window_end_cpu = build_warmup_schedule(num_warmup)
    slot_cpu, trail_cpu = checkpoint_tables(max_depth)
    n_tab = slot_cpu.shape[0]
    tables: dict = {}

    def _tables(dev) -> dict:
        """The schedule and checkpoint tables on ``dev`` (made once, before
        any capture: a host-to-device copy cannot be captured)."""
        key = str(dev)
        if key not in tables:
            tables[key] = {
                "in_window": in_window_cpu.to(dev),
                "window_end": window_end_cpu.to(dev),
                "slot": slot_cpu.to(dev), "trail": trail_cpu.to(dev),
                "depths": torch.arange(max_depth, device=dev),
            }
        return tables[key]

    def potential_vg(x: Tensor) -> tuple:
        """(U(x), ∇U(x)) per chain: autograd over the batched potential."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            pe = target.potential_fn(xg)
            (grad,) = torch.autograd.grad(pe, xg,
                                          grad_outputs=torch.ones_like(pe))
        return pe.detach(), grad

    def _leapfrog(z, r, grad, eps, inv_mass):
        """One leapfrog step per chain with signed step sizes ``eps`` (C,)."""
        e = eps[:, None]
        r = r - 0.5 * e * grad
        z = z + e * _velocity(inv_mass, r)
        pe, grad = potential_vg(z)
        pe = nan_to_inf(pe)
        grad = torch.where(torch.isfinite(grad), grad, 0.0)
        r = r - 0.5 * e * grad
        return z, r, pe, grad

    def _energy(pe, inv_mass, r):
        return nan_to_inf(pe + _kinetic(inv_mass, r))

    # -- step-size search --------------------------------------------------
    def _find_reasonable_step_size(n01, z, pe, grad, inv_mass, chol, eps0):
        """Per chain, double or halve ``eps0`` until the one-leapfrog
        acceptance crosses 1/2 (at most 64 times), as JAX's vmapped
        while_loop: a chain whose condition fails keeps its step size."""
        r = _sample_momentum(n01, chol)
        energy0 = pe + _kinetic(inv_mass, r)

        def accept_of(eps):
            _, r1, pe1, _ = _leapfrog(z, r, grad, eps, inv_mass)
            return torch.exp(energy0 - _energy(pe1, inv_mass, r1))

        eps = torch.full_like(pe, eps0)
        up = accept_of(eps) > 0.5
        factor = torch.where(up, 2.0, 0.5)
        active = torch.ones_like(up)
        for it in range(65):
            a = accept_of(eps)
            keep = torch.where(up, a > 0.5, a < 0.5)
            active = active & keep & (eps > 1e-8) & (eps < 1e7) & (it < 64)
            if not bool(active.any()):
                break
            eps = torch.where(active, eps * factor, eps)
        return eps

    # -- Welford + dual averaging ------------------------------------------
    def _welford_update(w: WelfordState, x) -> WelfordState:
        c = w.count + 1.0
        delta = x - w.mean
        mean = w.mean + delta / c[:, None]
        if dense:
            m2 = w.m2 + delta[:, :, None] * (x - mean)[:, None, :]
        else:
            m2 = w.m2 + delta * (x - mean)
        return WelfordState(c, mean, m2)

    def _welford_finalize(w: WelfordState) -> tuple:
        """Regularized covariance -> (inv_mass, chol_inv_mass)."""
        c = torch.clamp_min(w.count, 2.0)
        shrink = c / (c + 5.0)
        if dense:
            eye = torch.eye(d, device=w.m2.device)
            cov = w.m2 / (c - 1.0)[:, None, None]
            cov = shrink[:, None, None] * cov \
                + 1e-3 * (1.0 - shrink)[:, None, None] * eye
            # jnp.linalg.cholesky factors the symmetrized input and gives
            # NaN where it is not positive definite
            chol, info = torch.linalg.cholesky_ex(
                (cov + cov.transpose(-1, -2)) / 2)
            chol = torch.where((info > 0)[:, None, None],
                               torch.full_like(chol, float("nan")), chol)
            ok = ~torch.isnan(chol).flatten(1).any(dim=1)
            return _sel(ok, cov, eye.expand_as(cov)), \
                _sel(ok, chol, eye.expand_as(chol))
        cov = w.m2 / (c - 1.0)[:, None]
        cov = shrink[:, None] * cov + 1e-3 * (1.0 - shrink)[:, None]
        cov = torch.where(cov > 0, cov, 1.0)
        return cov, torch.sqrt(cov)

    def _fresh_welford(C: int, dev) -> WelfordState:
        shape = (C, d, d) if dense else (C, d)
        return WelfordState(torch.zeros(C, device=dev),
                            torch.zeros((C, d), device=dev),
                            torch.zeros(shape, device=dev))

    def _da_init(log_eps: Tensor) -> DAState:
        zeros = torch.zeros_like(log_eps)
        return DAState(t=zeros, log_eps=log_eps, log_eps_avg=zeros,
                       h_bar=zeros, mu=_LOG_10 + log_eps)

    def _da_update(da: DAState, stat: Tensor) -> DAState:
        t0, kappa, gamma = 10.0, 0.75, 0.05
        t = da.t + 1.0
        h_bar = (1.0 - 1.0 / (t + t0)) * da.h_bar + (
            config.target_accept_prob - stat) / (t + t0)
        log_eps = da.mu - torch.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_avg = w * log_eps + (1.0 - w) * da.log_eps_avg
        return DAState(t, log_eps, log_eps_avg, h_bar, da.mu)

    def _adapt(da, inv_mass, chol, wf, ap, x_new, i_glob, adapt_mask):
        """Warmup adaptation of the chains in ``adapt_mask`` that finished
        transition ``i_glob`` (C,) with acceptance ``ap`` at ``x_new``: dual
        averaging, the Welford window, and at a window's end the finalize
        and the restarted dual averaging, computed for every chain and
        selected (JAX: ``lax.cond`` on any window end)."""
        if not do_adapt:
            return da, inv_mass, chol, wf
        tab = _tables(x_new.device)
        idx = torch.clamp(i_glob, max=tab["in_window"].shape[0] - 1)
        in_win = tab["in_window"][idx] & adapt_mask
        win_end = tab["window_end"][idx] & adapt_mask
        if config.adapt_step_size:
            da = _sel_tree(adapt_mask, _da_update(da, ap), da)
        if config.adapt_mass_matrix:
            wf = _sel_tree(in_win, _welford_update(wf, x_new), wf)
            inv_f, chol_f = _welford_finalize(wf)
            inv_mass = _sel(win_end, inv_f, inv_mass)
            chol = _sel(win_end, chol_f, chol)
            wf = _sel_tree(win_end, _fresh_welford(x_new.shape[0],
                                                   x_new.device), wf)
            if config.adapt_step_size:
                da = _sel_tree(win_end, _da_init(da.log_eps), da)
        return da, inv_mass, chol, wf

    def _step_size(da: DAState, i_glob: Tensor) -> Tensor:
        """Step size of the transition at global iteration ``i_glob``."""
        if config.adapt_step_size:
            return torch.exp(torch.where(i_glob < num_warmup, da.log_eps,
                                         da.log_eps_avg))
        return torch.exp(da.log_eps)

    # -- init --------------------------------------------------------------
    def init(generator: Optional[torch.Generator] = None, n_chains: int = 1,
             position=None, adapt_state: Optional[NUTSAdaptState] = None,
             device=None, momentum: Optional[Tensor] = None) -> NUTSState:
        """Positions, their potentials and gradients, and a fresh adapt
        state whose step size comes from the search (its momenta drawn
        from ``generator`` or injected as ``momentum`` (C, d) normals)."""
        pos = batch_positions(target, generator, n_chains, position, device)
        dev = pos.device
        _tables(dev)
        pe, grad = potential_vg(pos)
        pe = nan_to_inf(pe)
        if adapt_state is None:
            if dense:
                inv_mass = torch.eye(d, device=dev).expand(
                    n_chains, d, d).clone()
            else:
                inv_mass = torch.ones((n_chains, d), device=dev)
            chol = inv_mass.clone()
            if config.adapt_step_size:
                if momentum is None:
                    if generator is None:
                        raise ValueError("the step-size search needs a "
                                         "torch.Generator or momentum")
                    momentum = torch.randn((n_chains, d), generator=generator,
                                           device=dev)
                eps0 = _find_reasonable_step_size(
                    momentum.to(dev), pos, pe, grad, inv_mass, chol,
                    config.step_size)
            else:
                eps0 = torch.full((n_chains,), config.step_size, device=dev)
            adapt_state = NUTSAdaptState(
                da=_da_init(torch.log(eps0)), inv_mass=inv_mass,
                chol_inv_mass=chol, welford=_fresh_welford(n_chains, dev))
        return NUTSState(
            i=torch.zeros((), dtype=torch.int32, device=dev),
            position=pos, potential_energy=pe, pe_grad=grad,
            mean_accept_prob=torch.zeros(n_chains, device=dev),
            num_steps=torch.zeros(n_chains, dtype=torch.int32, device=dev),
            diverging=torch.zeros(n_chains, dtype=torch.bool, device=dev),
            adapt_state=adapt_state,
        )

    # -- the lockstep transition -------------------------------------------
    def _subtree(src, depth, active, z, r, grad, eps_signed, inv_mass,
                 energy0):
        """Integrate ``2^depth`` leaves per chain of ``active`` from the edge
        (z, r, grad), with progressive multinomial proposal selection and
        the checkpoint U-turn checks of JAX's ``_build_subtree``; a chain
        stops at a U-turn or a divergence and is left untouched after.
        Every active chain is at leaf n together, so the checkpoint slot of
        leaf n is one number."""
        C = z.shape[0]
        dev = z.device
        zp, gp = z, grad
        pep = torch.zeros(C, device=dev)
        lw = torch.full((C,), float("-inf"), device=dev)
        rs = torch.zeros((C, d), device=dev)
        rck = torch.zeros((C, max_depth, d), device=dev)
        sck = torch.zeros((C, max_depth, d), device=dev)
        turning = torch.zeros(C, dtype=torch.bool, device=dev)
        diverging = torch.zeros_like(turning)
        acc = torch.zeros(C, device=dev)
        n_built = torch.zeros(C, dtype=torch.int32, device=dev)
        for n in range(1 << depth):
            act = active & ~turning & ~diverging
            if not bool(act.any()):
                break
            z1, r1, pe1, g1 = _leapfrog(z, r, grad, eps_signed, inv_mass)
            energy = _energy(pe1, inv_mass, r1)
            delta = energy - energy0
            lw_leaf = -energy
            lw_new = torch.logaddexp(lw, lw_leaf)
            take = act & (src.leaf(depth, n) < torch.exp(lw_leaf - lw_new))
            zp, pep, gp = (_sel(take, z1, zp), torch.where(take, pe1, pep),
                           _sel(take, g1, gp))
            acc = torch.where(act, acc + torch.clamp_max(torch.exp(-delta),
                                                         1.0), acc)
            rs_new = rs + r1
            slot = bin(n >> 1).count("1")
            if n % 2 == 0:
                # push the first-leaf checkpoint of the subtrees leaf n opens
                rck[:, slot] = _sel(act, r1, rck[:, slot])
                sck[:, slot] = _sel(act, rs, sck[:, slot])
            else:
                # leaf n closes the subtrees whose checkpoints sit at slots
                # (slot - trailing ones of n, slot]
                lo = slot - ((n ^ (n + 1)).bit_length() - 1) + 1
                rho = rs_new[:, None, :] - sck[:, lo:slot + 1]
                v_first = _velocity_rows(inv_mass, rck[:, lo:slot + 1])
                v_last = _velocity(inv_mass, r1)
                turn = (torch.sum(v_first * rho, -1) <= 0.0) | (
                    torch.sum(rho * v_last[:, None, :], -1) <= 0.0)
                turning = turning | (act & turn.any(dim=1))
            z, r = _sel(act, z1, z), _sel(act, r1, r)
            grad = _sel(act, g1, grad)
            lw = torch.where(act, lw_new, lw)
            rs = _sel(act, rs_new, rs)
            diverging = diverging | (act & (delta > max_delta))
            n_built = n_built + act.to(torch.int32)
        return z, r, grad, zp, pep, gp, lw, rs, turning, diverging, acc, \
            n_built

    def _transition(src, z, pe, grad, eps, inv_mass, chol):
        """One lockstep NUTS transition of every chain (JAX's vmapped
        ``_single_transition``): (position, potential, gradient, accept
        prob, num_steps, diverging)."""
        r0 = _sample_momentum(src.momentum(), chol)
        energy0 = pe + _kinetic(inv_mass, r0)
        zl = zr = zp = z
        rl = rr = rs = r0
        gl = gr = gp = grad
        pep = pe
        lw = -energy0
        turning = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
        diverging = torch.zeros_like(turning)
        acc = torch.zeros_like(pe)
        num_steps = torch.zeros_like(turning, dtype=torch.int32)
        for depth in range(max_depth):
            active = ~turning & ~diverging
            if not bool(active.any()):
                break
            right = src.direction(depth) < 0.5
            (sz, sr, sg, szp, spep, sgp, slw, srs, sturn, sdiv, sacc,
             sn) = _subtree(src, depth, active, _sel(right, zr, zl),
                            _sel(right, rr, rl), _sel(right, gr, gl),
                            torch.where(right, eps, -eps), inv_mass, energy0)
            invalid = sturn | sdiv
            accept_p = torch.exp(torch.clamp_max(slw - lw, 0.0))
            take = active & (src.bias(depth) < accept_p) & ~invalid
            zp, pep, gp = (_sel(take, szp, zp), torch.where(take, spep, pep),
                           _sel(take, sgp, gp))
            left, rgt = active & ~right, active & right
            zl, rl, gl = _sel(left, sz, zl), _sel(left, sr, rl), \
                _sel(left, sg, gl)
            zr, rr, gr = _sel(rgt, sz, zr), _sel(rgt, sr, rr), \
                _sel(rgt, sg, gr)
            rs = _sel(active, rs + srs, rs)
            lw = torch.where(active, torch.logaddexp(lw, slw), lw)
            turning = torch.where(
                active, invalid | _is_turning(inv_mass, rl, rr, rs), turning)
            diverging = torch.where(active, sdiv, diverging)
            acc = torch.where(active, acc + sacc, acc)
            num_steps = torch.where(active, num_steps + sn, num_steps)
        accept_prob = acc / torch.clamp_min(num_steps.to(torch.float32), 1.0)
        return zp, pep, gp, accept_prob, num_steps, diverging

    def step(state: NUTSState, generator: Optional[torch.Generator] = None,
             draws: Optional[NUTSDraws] = None) -> NUTSState:
        adapt = state.adapt_state
        C = state.position.shape[0]
        in_warmup = state.i < num_warmup
        eps = _step_size(adapt.da, state.i)
        src = _LockstepDraws(draws, generator, C, d, state.position.device)
        z_new, pe_new, grad_new, accept_prob, num_steps, diverging = \
            _transition(src, state.position, state.potential_energy,
                        state.pe_grad, eps, adapt.inv_mass,
                        adapt.chol_inv_mass)
        itr = state.i + 1
        n = torch.where(in_warmup, itr, itr - num_warmup).to(torch.float32)
        mean_ap = state.mean_accept_prob
        mean_ap = mean_ap + (accept_prob - mean_ap) / n
        da, inv_mass, chol, wf = _adapt(
            adapt.da, adapt.inv_mass, adapt.chol_inv_mass, adapt.welford,
            accept_prob, z_new, state.i.expand(C), in_warmup.expand(C))
        return NUTSState(
            i=itr, position=z_new, potential_energy=pe_new,
            pe_grad=grad_new, mean_accept_prob=mean_ap, num_steps=num_steps,
            diverging=diverging & ~in_warmup,
            adapt_state=NUTSAdaptState(da, inv_mass, chol, wf),
        )

    # -- the pipelined machine ---------------------------------------------
    def _trip_draws(U: Tensor) -> tuple:
        """(u_acc, u_bias, going right, momentum normals (C, d)) from one
        trip's uniforms U (3 + d, C)."""
        n01 = _SQRT2 * torch.erfinv(torch.clamp_min(2.0 * U[3:] - 1.0, _U_LO))
        return U[0], U[1], U[2] < 0.5, n01.t()

    def _momentum(n01, pe, da, inv_mass, chol, i_glob) -> tuple:
        """(step size, momentum, energy) of the transition ``i_glob`` a chain
        opens, its momentum from the trip's normals."""
        eps = _step_size(da, i_glob)
        r0 = _sample_momentum(n01, chol)
        return eps, r0, pe + _kinetic(inv_mass, r0)

    def _trip(p: dict, ctx: dict, U: Tensor, adapting: bool = True) -> dict:
        """One machine trip (JAX ``_drive``'s ``body``): one batched
        leapfrog, then each chain's subtree, tree and transition
        bookkeeping.  ``p`` holds the machine, ``ctx`` the call's constants
        (``n_steps``, ``i0``, ``thin``) and frame buffers, written in place
        as chains complete frames.  ``adapting=False`` leaves out the
        warmup adaptation, which changes nothing in a call that starts
        after warmup."""
        tab = _tables(U.device)
        active = p["done"] < ctx["n_steps"]
        u_acc, u_b, gr_draw, n01 = _trip_draws(U)
        inv = p["inv_mass"]

        # the one batched leapfrog of this trip
        z, r, pe_l, g = _leapfrog(p["sz"], p["sr"], p["sg"], p["esg"], inv)
        energy = _energy(pe_l, inv, r)
        delta = energy - p["energy0"]
        lw_leaf = -energy
        slw = torch.logaddexp(p["slw"], lw_leaf)
        take = u_acc < torch.exp(lw_leaf - slw)
        szp, spep, sgp = (_sel(take, z, p["szp"]),
                          torch.where(take, pe_l, p["spep"]),
                          _sel(take, g, p["sgp"]))
        sacc = p["sacc"] + torch.clamp_max(torch.exp(-delta), 1.0)
        # checkpoint push (even leaves) and subtree closes (odd leaves) on
        # every slot, masked; a chain past its call's end counts leaves on,
        # so its table index is clamped
        n = p["sn"]
        idx = torch.clamp(n, max=n_tab - 1)
        srs = p["srs"] + r
        is_even = (n % 2) == 0
        slot, t = tab["slot"][idx], tab["trail"][idx]
        jd = tab["depths"][None, :]                                # (1, D)
        onehot = ((jd == slot[:, None]) & is_even[:, None])[:, :, None]
        rck = torch.where(onehot, r[:, None, :], p["rck"])
        sck = torch.where(onehot, p["srs"][:, None, :], p["sck"])
        rho_all = srs[:, None, :] - sck                            # (C, D, d)
        v_first = _velocity_rows(inv, rck)
        v_last = _velocity(inv, r)
        turn_all = (torch.sum(v_first * rho_all, -1) <= 0.0) | (
            torch.sum(rho_all * v_last[:, None, :], -1) <= 0.0)    # (C, D)
        sel_slots = (~is_even)[:, None] & (jd <= slot[:, None]) \
            & (jd > (slot - t)[:, None])
        sturn = p["sturn"] | (turn_all & sel_slots).any(dim=1)
        sdiv = p["sdiv"] | (delta > max_delta)
        sn = n + 1

        # subtree close -> biased merge into the tree
        sub_done = active & ((sn >= p["snl"]) | sturn | sdiv)
        invalid = sturn | sdiv
        accept_p = torch.exp(torch.clamp_max(slw - p["tlw"], 0.0))
        take_t = sub_done & (u_b < accept_p) & ~invalid
        tzp, tpep, tgp = (_sel(take_t, szp, p["tzp"]),
                          torch.where(take_t, spep, p["tpep"]),
                          _sel(take_t, sgp, p["tgp"]))
        ml = sub_done & ~p["sgr"]
        mr = sub_done & p["sgr"]
        tzl, trl, tgl = (_sel(ml, z, p["tzl"]), _sel(ml, r, p["trl"]),
                         _sel(ml, g, p["tgl"]))
        tzr, trr, tgr = (_sel(mr, z, p["tzr"]), _sel(mr, r, p["trr"]),
                         _sel(mr, g, p["tgr"]))
        trs = _sel(sub_done, p["trs"] + srs, p["trs"])
        tlw = torch.where(sub_done, torch.logaddexp(p["tlw"], slw), p["tlw"])
        tturn = sub_done & (invalid | _is_turning(inv, trl, trr, trs))
        tdiv = sub_done & sdiv
        tdep = torch.where(sub_done, p["tdep"] + 1, p["tdep"])
        tacc = torch.where(sub_done, p["tacc"] + sacc, p["tacc"])
        tns = torch.where(sub_done, p["tns"] + sn, p["tns"])
        tree_done = sub_done & (tturn | tdiv | (tdep >= max_depth))
        tree_cont = sub_done & ~tree_done

        # finalize completed transitions, each on its own warmup clock
        i_glob = ctx["i0"] + p["done"]
        in_warm = i_glob < num_warmup
        ap = tacc / torch.clamp_min(tns.to(torch.float32), 1.0)
        x_new = _sel(tree_done, tzp, p["x"])
        pe_new = torch.where(tree_done, tpep, p["pe"])
        grad_new = _sel(tree_done, tgp, p["grad"])
        itr = i_glob + 1
        nf = torch.where(in_warm, itr, itr - num_warmup).to(torch.float32)
        mean_ap = torch.where(tree_done,
                              p["mean_ap"] + (ap - p["mean_ap"]) / nf,
                              p["mean_ap"])
        ns_last = torch.where(tree_done, tns, p["ns_last"])
        div_last = torch.where(tree_done, tdiv & ~in_warm, p["div_last"])
        da, inv_mass, chol, wf = p["da"], inv, p["chol"], p["wf"]
        if adapting:
            da, inv_mass, chol, wf = _adapt(da, inv_mass, chol, wf, ap, x_new,
                                            i_glob, tree_done & in_warm)
        done = p["done"] + tree_done.to(torch.int32)
        start_new = tree_done & (done < ctx["n_steps"])
        if "fx" in ctx:
            thin, F = ctx["thin"], ctx["fx"].shape[1]
            f = done // thin - 1
            rec = tree_done & (done % thin == 0) & (f < F)
            at = (ctx["chains"], torch.clamp(f, 0, F - 1).long())
            ctx["fx"].index_put_(at, _sel(rec, x_new, ctx["fx"][at]))
            ctx["fpe"].index_put_(at, torch.where(rec, pe_new,
                                                  ctx["fpe"][at]))

        # Finished chains (but those done with the call) open the next
        # transition from the finalized state, continuing trees the next
        # subtree from the drawn edge; either way the subtree restarts.
        eps0, r0, e0 = _momentum(n01, pe_new, da, inv_mass, chol,
                                 ctx["i0"] + done)
        opened = start_new | tree_cont
        tdep = torch.where(start_new, 0, tdep)
        eps = torch.where(start_new, eps0, p["eps"])
        edge_z = _sel(start_new, x_new, _sel(gr_draw, tzr, tzl))
        edge_g = _sel(start_new, grad_new, _sel(gr_draw, tgr, tgl))
        edge_r = _sel(start_new, r0, _sel(gr_draw, trr, trl))
        out = dict(
            done=done, x=x_new, pe=pe_new, grad=grad_new, mean_ap=mean_ap,
            ns_last=ns_last, div_last=div_last, da=da, inv_mass=inv_mass,
            chol=chol, wf=wf, eps=eps,
            energy0=torch.where(start_new, e0, p["energy0"]),
            tzl=_sel(start_new, x_new, tzl), trl=_sel(start_new, r0, trl),
            tgl=_sel(start_new, grad_new, tgl),
            tzr=_sel(start_new, x_new, tzr), trr=_sel(start_new, r0, trr),
            tgr=_sel(start_new, grad_new, tgr),
            tzp=_sel(start_new, x_new, tzp),
            tpep=torch.where(start_new, pe_new, tpep),
            tgp=_sel(start_new, grad_new, tgp),
            tlw=torch.where(start_new, -e0, tlw),
            trs=_sel(start_new, r0, trs), tdep=tdep,
            tacc=torch.where(start_new, 0.0, tacc),
            tns=torch.where(start_new, 0, tns),
            sgr=torch.where(opened, gr_draw, p["sgr"]),
            sn=torch.where(opened, 0, sn),
            snl=torch.where(opened, torch.bitwise_left_shift(
                torch.ones_like(tdep), torch.clamp(tdep, max=max_depth - 1)),
                p["snl"]),
            sz=_sel(opened, edge_z, z), sr=_sel(opened, edge_r, r),
            sg=_sel(opened, edge_g, g), szp=_sel(opened, edge_z, szp),
            spep=torch.where(opened, torch.where(start_new, pe_new, 0.0),
                             spep),
            sgp=_sel(opened, edge_g, sgp),
            slw=torch.where(opened, float("-inf"), slw),
            srs=torch.where(opened[:, None], 0.0, srs),
            rck=torch.where(opened[:, None, None], 0.0, rck),
            sck=torch.where(opened[:, None, None], 0.0, sck),
            sturn=sturn & ~opened, sdiv=sdiv & ~opened,
            sacc=torch.where(opened, 0.0, sacc),
            esg=torch.where(opened, torch.where(gr_draw, eps, -eps),
                            p["esg"]),
        )
        return out

    def _open(state: NUTSState, U0: Tensor) -> dict:
        """The machine at the start of a call, every chain opening its next
        transition with row 0 of the draws."""
        a = state.adapt_state
        x, pe, grad = state.position, state.potential_energy, state.pe_grad
        C = x.shape[0]
        dev = x.device
        _, _, right, n01 = _trip_draws(U0)
        eps, r0, e0 = _momentum(n01, pe, a.da, a.inv_mass, a.chol_inv_mass,
                                state.i.expand(C))
        zero_i = torch.zeros(C, dtype=torch.int32, device=dev)
        zeros_ck = torch.zeros((C, max_depth, d), device=dev)
        return dict(
            done=zero_i, x=x, pe=pe, grad=grad,
            mean_ap=state.mean_accept_prob, ns_last=state.num_steps,
            div_last=state.diverging, da=a.da, inv_mass=a.inv_mass,
            chol=a.chol_inv_mass, wf=a.welford, eps=eps, energy0=e0,
            tzl=x, trl=r0, tgl=grad, tzr=x, trr=r0, tgr=grad,
            tzp=x, tpep=pe, tgp=grad, tlw=-e0, trs=r0,
            tdep=zero_i, tacc=torch.zeros(C, device=dev), tns=zero_i,
            sgr=right, sn=zero_i, snl=torch.ones_like(zero_i),
            sz=x, sr=r0, sg=grad, szp=x, spep=pe, sgp=grad,
            slw=torch.full((C,), float("-inf"), device=dev),
            srs=torch.zeros((C, d), device=dev), rck=zeros_ck, sck=zeros_ck,
            sturn=torch.zeros(C, dtype=torch.bool, device=dev),
            sdiv=torch.zeros(C, dtype=torch.bool, device=dev),
            sacc=torch.zeros(C, device=dev),
            esg=torch.where(right, eps, -eps))

    def _result(state: NUTSState, p: dict, n_steps: int) -> NUTSState:
        return NUTSState(
            i=state.i + n_steps, position=p["x"], potential_energy=p["pe"],
            pe_grad=p["grad"], mean_accept_prob=p["mean_ap"],
            num_steps=p["ns_last"], diverging=p["div_last"],
            adapt_state=NUTSAdaptState(p["da"], p["inv_mass"], p["chol"],
                                       p["wf"]))

    # the machine of calls that start in warmup, and of those that start
    # after it (no adaptation: some 60 fewer kernels per trip)
    machines = {adapting: (BlockMachine("nuts.step_n", ("fx", "fpe")),
                           functools.partial(_trip, adapting=adapting))
                for adapting in (True, False)}

    def _drive(state: NUTSState, n_steps: int, n_frames: int, thinning: int,
               generator, unif, eager: bool):
        C = state.position.shape[0]
        dev = state.position.device
        if thinning < 1 or n_frames < 0 or n_frames * thinning > n_steps:
            raise ValueError("need thinning >= 1 and n_frames * thinning <= "
                             "n_steps")
        if unif is None:
            if generator is None:
                raise ValueError("step_n / collect_n need a torch.Generator "
                                 "or injected draws")

            def draw(p, ctx):
                return torch.rand((3 + d, C), generator=generator,
                                  device=dev)
        else:
            unif = torch.as_tensor(unif, dtype=torch.float32, device=dev)
            if unif.dim() != 3 or tuple(unif.shape[1:]) != (3 + d, C):
                raise ValueError(f"injected draws must be (R, {3 + d}, {C}); "
                                 f"got {tuple(unif.shape)}")
            row = itertools.count()

            def draw(p, ctx):
                s = next(row)
                if s < unif.shape[0]:
                    return unif[s]
                if p is None or bool((p["done"] < ctx["n_steps"]).any()):
                    raise ValueError(f"the injected draws end after "
                                     f"{unif.shape[0]} rows, before the "
                                     f"machine does")
                return unif[-1]
        graph = dev.type == "cuda" and not eager and unif is None
        saved = generator.get_state() if graph else None
        p = _open(state, draw(None, None))
        frames = {}
        if n_frames:
            frames = {"fx": torch.zeros((C, n_frames, d), device=dev),
                      "fpe": torch.zeros((C, n_frames), device=dev)}
        ctx = {"n_steps": torch.tensor(n_steps, dtype=torch.int32,
                                       device=dev),
               "i0": state.i.to(device=dev, dtype=torch.int32),
               "thin": torch.tensor(thinning, dtype=torch.int32, device=dev),
               "chains": torch.arange(C, device=dev), **frames}
        machine, trip = machines[do_adapt and int(state.i) < num_warmup]
        p, ctx = machine.run(p, ctx, lambda q, c: trip(q, c, draw(q, c)),
                             GRAPH_TRIPS, _count,
                             generator if graph else None, saved)
        out = {}
        if n_frames:
            out = {"position": ctx["fx"], "potential_energy": ctx["fpe"]}
        return _result(state, p, n_steps), out

    def step_n(state: NUTSState, n_steps: int,
               generator: Optional[torch.Generator] = None, unif=None, *,
               eager: bool = False) -> NUTSState:
        return _drive(state, n_steps, 0, 1, generator, unif, eager)[0]

    def collect_n(state: NUTSState, n_frames: int, thinning: int = 1,
                  generator: Optional[torch.Generator] = None, unif=None, *,
                  eager: bool = False):
        return _drive(state, n_frames * thinning, n_frames, thinning,
                      generator, unif, eager)

    return Kernel(
        name="nuts",
        target=target,
        config=config,
        init=init,
        step=step,
        step_n=step_n if config.pipeline else None,
        collect_n=collect_n if config.pipeline else None,
        collect_fields=("position", "potential_energy"),
    )
