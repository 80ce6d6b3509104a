"""Experiment runners: w_eval and lr_decay sweeps (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/experiments/runner.py``.  The seed axis
is a chain axis: one batched run carries every seed (each "chain" one
seed's independent chain), so a 100-seed sweep is one run on the card.
Outputs land as .npz per (target, kernel): thinned samples (seeds, draws,
dim), the potential energy and the config JSON, with a SweepManifest for
restartability; the same files, keys and layouts as the JAX package's.

Every entry point runs on the card unless ``device="cpu"`` is passed; a
run's seed is ``torch.Generator(device).manual_seed(seed0)`` and its wall
clock ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from adaptive_mcmc_tpu_torch import kernels as _kernels
from adaptive_mcmc_tpu_torch import models as _models
from adaptive_mcmc_tpu_torch.experiments.configs import (
    LR_DECAYS,
    OUT_ROOT,
    RunConfig,
)
from adaptive_mcmc_tpu_torch.infer.collect import collect_states_logscale
from adaptive_mcmc_tpu_torch.infer.mcmc import collector
from adaptive_mcmc_tpu_torch.utils import profiling
from adaptive_mcmc_tpu_torch.utils.checkpoint import SweepManifest

TARGETS: Dict[str, Callable] = {
    "eight_schools": _models.eight_schools_noncentered,
    "eight_schools_centered": _models.eight_schools_centered,
    "diamonds": _models.diamonds,
    "kidiq": _models.kidiq,
}


def run_device(device=None) -> torch.device:
    """The device of a run: ``device``, or the card.  Raises where no CUDA
    device is present and none was named (nothing runs on the CPU
    unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (CLI "
                           "--device cpu) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the kernels with a fused whole-sweep kernel, and its name
FUSED_KERNELS = {"arwmh": "K2", "asss": "K3"}


def _w_eval_fields(kernel) -> tuple:
    """The extra fields a w_eval run collects beside the draws."""
    if kernel.name in ("arwmh", "rwm", "asss"):
        return ("potential_energy", "as_change")
    return ("potential_energy",)


def _driver_name(kernel) -> str:
    """The driver that collects a w_eval run's fields
    (``infer.mcmc.collector``), the provenance stamp of the saved npz: a
    fused kernel adds its name (``collect_n:K2``, ``collect_n:K3``), so a
    fused row never reads as the ASSS machine's ``collect_n``."""
    name = collector(kernel, (kernel.sample_field, *_w_eval_fields(kernel)))
    if getattr(kernel.config, "fused", False):
        name += f":{FUSED_KERNELS[kernel.name]}"
    return name


def build_kernel(name: str, target, *, lr_decay: float, num_warmup: int,
                 fused=None):
    """The kernel of a harness cell.  ``fused`` is ``ARWMHConfig`` /
    ``ASSSConfig``'s field: True runs ARWMH through K2 and ASSS through K3
    at any dimension (the switch the JAX sweep reaches through
    ``AMT_*_FUSED``, without the auto-pick's d <= 16), False the lockstep
    step / the pipelined machine, None (the default) the kernels' own
    pick.  NUTS, SA and RWM have no fused kernel: ``fused=True`` raises."""
    if fused and name not in FUSED_KERNELS:
        raise ValueError(f"{name!r} has no fused kernel (fused=True is for "
                         "arwmh (K2) and asss (K3))")
    if name in ("arwmh", "rwm"):
        cfg = _kernels.ARWMHConfig(
            lr_decay=lr_decay, num_warmup=num_warmup,
            adapt=(name == "arwmh"), fused=fused,
        )
        return _kernels.arwmh(target, cfg)
    if name == "asss":
        return _kernels.asss(target, _kernels.ASSSConfig(
            lr_decay=lr_decay, num_warmup=num_warmup, fused=fused))
    if name == "nuts":
        return _kernels.nuts(target, _kernels.NUTSConfig(
            num_warmup=num_warmup))
    if name == "sa":
        return _kernels.sa(target, _kernels.SAConfig(num_warmup=num_warmup))
    raise ValueError(f"unknown kernel {name!r}")


@profiling.spanned("run_w_eval")
def run_w_eval(config: RunConfig, verbose: bool = True, *,
               device=None) -> Path:
    """Run the w_eval experiment for one (target, kernel): all seeds as one
    chain batch; save thinned draws + PE + the run's meta.

    ``config.mesh_devices`` splits the chains over that many processes of
    the process group (``parallel.chain_mesh``; torchrun, one process per
    device), padded to a multiple of it as in JAX: every process calls
    this function, each samples its block, and the draws are gathered.
    Rank 0 alone decides whether the cell is already complete (and tells
    the others) and writes the npz and the manifest; the meta's
    ``wall_seconds`` is the slowest process's.  A process outside a
    sub-mesh returns None.

    The call is the span ``run_w_eval`` (``utils.profiling``), with the
    spans ``run_w_eval.build`` (the target and the kernel), ``.sample``
    (the sharded run, closed by a synchronize), ``.to_host`` (the draws
    copied to the host) and ``.save`` (the npz and the manifest) in it."""
    from adaptive_mcmc_tpu_torch.parallel import chain_mesh, run_mcmc_sharded

    out_dir = Path(config.out_dir) / "w_eval" / config.target
    out_path = out_dir / f"{config.kernel}.npz"
    key = f"{config.kernel}"
    mesh = chain_mesh(config.mesh_devices, devices=[run_device(device)])
    if not mesh.member:
        return None
    dev = mesh.device
    lead = mesh.rank == 0
    manifest = SweepManifest(out_dir / "manifest.json") if lead else None
    done = torch.tensor(
        int(lead and manifest.is_done(key) and out_path.exists()),
        dtype=torch.int32, device=dev)
    if mesh.size > 1:
        # one decision for every process: a process that skipped would
        # leave the others waiting in the gather
        dist.broadcast(done, src=0, group=mesh.group)
    if bool(done):
        if verbose and lead:
            print(f"[skip] {out_path} already complete")
        return out_path

    with profiling.span("run_w_eval.build"):
        target = TARGETS[config.target]()
        kernel = build_kernel(
            config.kernel, target,
            lr_decay=config.lr_decay, num_warmup=config.num_warmup,
            fused=config.fused,
        )
    n_chains = config.n_seeds * config.chains_per_seed
    # pad chains to a mesh multiple
    n_padded = -(-n_chains // mesh.size) * mesh.size

    generator = torch.Generator(dev).manual_seed(config.seed0)
    # bound single driver calls, as the JAX runner bounds device programs
    max_steps = {"nuts": 20_000, "sa": 50_000}.get(config.kernel, 500_000)
    F = max(1, config.fan_out)
    with profiling.span("run_w_eval.sample"):
        synchronize(dev)
        t0 = time.perf_counter()
        samples, extras, last = run_mcmc_sharded(
            kernel,
            generator,
            config.num_warmup,
            config.num_samples,
            thinning=config.thinning,
            n_chains=n_padded,
            mesh=mesh,
            max_steps_per_call=max_steps,
            fan_out=F,
            extra_fields=_w_eval_fields(kernel),
        )
        synchronize(dev)
        wall = torch.tensor(time.perf_counter() - t0, dtype=torch.float64,
                            device=dev)
        if mesh.size > 1:
            dist.all_reduce(wall, op=dist.ReduceOp.MAX, group=mesh.group)
        wall = float(wall)
    if not lead:
        return out_path

    def _per_seed(a):
        """(frames, n_padded*F, ...) -> (seeds, frames*F, ...): clones are
        contiguous per chain; pooled into the seed's draw axis."""
        a = a.cpu().numpy()
        a = a.reshape(a.shape[0], n_padded, F, *a.shape[2:])[:, :n_chains]
        a = np.moveaxis(a, 0, 1)  # (seeds, frames, F, ...)
        return a.reshape(a.shape[0], -1, *a.shape[3:])

    total_iters = (config.num_warmup + config.num_samples) * n_chains
    meta = {
        "config": json.loads(config.to_json()),
        "wall_seconds": wall,
        "chain_iters_per_sec": total_iters / wall,
        # provenance stamp: which step driver generated these draws
        # (pipelined in-driver collector / pipelined step_n / plain
        # lockstep, with :K2 / :K3 where fused)
        "driver": _driver_name(kernel),
    }
    with profiling.span("run_w_eval.to_host"):
        draws = {"samples": _per_seed(samples),  # (seeds, draws, dim)
                 "potential_energy": _per_seed(extras["potential_energy"])}
    with profiling.span("run_w_eval.save"):
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out_path, **draws, meta=json.dumps(meta))
        manifest.mark_done(key)
    if verbose:
        print(
            f"[done] {out_path}: {total_iters / wall:,.0f} chain-iters/s "
            f"({wall:.1f}s)"
        )
    return out_path


def run_lr_decay(
    target_name: str,
    kernel_name: str,
    *,
    n_pow: int = 6,
    n_seeds: int = 100,
    lr_decays=LR_DECAYS,
    out_dir: str = OUT_ROOT,
    seed0: int = 0,
    verbose: bool = True,
    device=None,
    fused=None,
):
    """Log-scale state-trajectory sweep: for each lr_decay, ONE batched run
    carries all seeds; saves i / position / PE / as_change trajectories on
    the log grid, plus the small committable summary CSV
    (experiments/summaries.py) of across-seed quantiles.

    Skip predicates are artifact-keyed (not manifest-only): a cell is
    complete iff its summary CSV is on disk; a surviving npz with a
    missing summary is backfilled without re-running the sweep.
    ``fused`` as in :func:`build_kernel` (True: K2 / K3)."""
    from adaptive_mcmc_tpu_torch.experiments.summaries import (
        summary_path_for,
        write_lr_decay_summary,
    )

    target = TARGETS[target_name]()
    base = Path(out_dir) / "lr_decay" / target_name / kernel_name
    manifest = SweepManifest(base / "manifest.json")
    out_paths = []
    for lr_decay in lr_decays:
        tag = f"{lr_decay:.4g}"
        out_path = base / f"decay_{tag}.npz"
        summary = summary_path_for(out_path)
        if manifest.is_done(tag) and summary.exists():
            out_paths.append(out_path)
            continue
        if out_path.exists() and not summary.exists():
            # the trajectories survived but the summary did not: derive
            # it, do not re-run 10^n_pow steps
            write_lr_decay_summary(
                out_path,
                {"target": target_name, "kernel": kernel_name,
                 "lr_decay": tag, "n_pow": n_pow, "backfilled": True},
            )
            manifest.mark_done(tag)
            out_paths.append(out_path)
            continue
        dev = run_device(device)
        kernel = build_kernel(
            kernel_name, target, lr_decay=lr_decay, num_warmup=0,
            fused=fused,
        )
        # bound driver calls: ASSS steps cost ~5-10x ARWMH's, so cap
        # tighter
        cap = 40_000 if kernel_name == "asss" else 200_000
        synchronize(dev)
        t0 = time.perf_counter()
        states, _ = collect_states_logscale(
            kernel, torch.Generator(dev).manual_seed(seed0), n_pow=n_pow,
            n_chains=n_seeds, max_steps_per_call=cap, device=dev,
        )
        synchronize(dev)
        wall = time.perf_counter() - t0
        base.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out_path,
            i=states.i.cpu().numpy(),
            position=states.position.cpu().numpy(),
            potential_energy=states.potential_energy.cpu().numpy(),
            as_change=states.as_change.cpu().numpy(),
        )
        meta = {"target": target_name, "kernel": kernel_name,
                "lr_decay": tag, "n_pow": n_pow,
                "wall_seconds": f"{wall:.2f}"}
        if getattr(kernel.config, "fused", False):
            # the stamp of a fused run, whose grid points are K2 / K3
            # step_n calls (the JAX summaries have no driver key, and a
            # default run's meta stays theirs)
            meta["driver"] = f"step_n:{FUSED_KERNELS[kernel_name]}"
        write_lr_decay_summary(out_path, meta)
        manifest.mark_done(tag)
        if verbose:
            print(f"[done] {out_path} ({wall:.1f}s)")
        out_paths.append(out_path)
    return out_paths
