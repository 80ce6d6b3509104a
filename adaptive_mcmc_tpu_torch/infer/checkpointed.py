"""Checkpointed long-run driver: chunked sampling with resumable state
(PyTorch).

Counterpart of ``adaptive_mcmc_tpu/infer/checkpointed.py``.  A long run
streams through chunks of ``chunk_size`` post-warmup iterations, each one
``run_mcmc`` call; after each chunk its draws, the kernel state
(``state.npz``) and the generator's state (``generator.npy``) are written,
then ``progress.json``.  :func:`run_mcmc_checkpointed` called again with
the same ``checkpoint_dir`` resumes after the last completed chunk, and
draws exactly what the uninterrupted run draws: where the JAX state carries
its PRNG keys, the port's draws come from the generator, whose state is
restored with the kernel's.  An optional per-chunk health check (finite
positions, few infinite potentials) stops a run that has gone bad with a
diagnosis.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import run_mcmc
from adaptive_mcmc_tpu_torch.utils.checkpoint import load_state, save_state


class ChainHealthError(RuntimeError):
    pass


def check_chain_health(state, *, max_bad_frac: float = 0.0):
    """Raise if chains have gone numerically bad: non-finite positions or
    a fraction of +inf potential energies above ``max_bad_frac``."""
    pos_ok = bool(torch.all(torch.isfinite(state.position)))
    pe = state.potential_energy
    bad_frac = float(torch.mean((~torch.isfinite(pe)).to(torch.float32)))
    if not pos_ok:
        raise ChainHealthError("non-finite chain positions detected")
    if bad_frac > max_bad_frac:
        raise ChainHealthError(
            f"{bad_frac:.1%} of chains have non-finite potential energy"
        )


def run_mcmc_checkpointed(
    kernel,
    generator: torch.Generator,
    num_warmup: int,
    num_samples: int,
    *,
    thinning: int = 1,
    n_chains: int = 1,
    checkpoint_dir: str | Path,
    chunk_size: int = 100_000,
    extra_fields: Sequence[str] = (),
    init_position=None,
    health_check: bool = True,
    verbose: bool = False,
):
    """Like ``run_mcmc`` but resumable: work proceeds in chunks of
    ``chunk_size`` post-warmup iterations; after each chunk the kernel
    state, the generator's state and the collected draws are persisted.
    Re-invoking with the same ``checkpoint_dir`` restores ``generator``
    and resumes after the last completed chunk.  Returns ``(samples,
    extras, last_state)`` with numpy draws."""
    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    meta_path = ckpt_dir / "progress.json"
    state_path = ckpt_dir / "state.npz"
    gen_path = ckpt_dir / "generator.npy"

    chunk_size = (max(chunk_size, thinning) // thinning) * thinning
    done_iters = 0
    state = None
    if meta_path.exists() and state_path.exists():
        meta = json.loads(meta_path.read_text())
        done_iters = meta["done_iters"]
        template = kernel.init(
            torch.Generator(generator.device).manual_seed(0),
            n_chains=n_chains)
        state = load_state(state_path, template)
        generator.set_state(torch.from_numpy(np.load(gen_path)))
        if verbose:
            print(f"[resume] {done_iters}/{num_samples} iterations done")

    if state is None:
        state = kernel.init(generator, n_chains=n_chains,
                            position=init_position)
        if num_warmup:
            _, _, state = run_mcmc(kernel, generator, num_warmup, 0,
                                   n_chains=n_chains, init_state=state)
        if health_check:
            check_chain_health(state, max_bad_frac=0.05)

    while done_iters < num_samples:
        todo = min(chunk_size, num_samples - done_iters)
        samples, extras, state = run_mcmc(
            kernel, generator, 0, todo, thinning=thinning,
            n_chains=n_chains, extra_fields=extra_fields, init_state=state,
        )
        if health_check:
            check_chain_health(state, max_bad_frac=0.05)
        chunk_idx = done_iters // chunk_size
        np.savez_compressed(
            ckpt_dir / f"chunk_{chunk_idx:05d}.npz",
            samples=samples.cpu().numpy(),
            **{k: v.cpu().numpy() for k, v in extras.items()},
        )
        save_state(state_path, state)
        np.save(gen_path, generator.get_state().numpy())
        done_iters += todo
        meta_path.write_text(json.dumps({"done_iters": done_iters}))
        if verbose:
            print(f"[chunk] {done_iters}/{num_samples}")

    # stitch chunks
    chunks = sorted(ckpt_dir.glob("chunk_*.npz"))
    samples = np.concatenate(
        [np.load(c)["samples"] for c in chunks], axis=0
    )
    extras_out = {}
    for f in extra_fields:
        extras_out[f] = np.concatenate(
            [np.load(c)[f] for c in chunks], axis=0
        )
    return samples, extras_out, state
