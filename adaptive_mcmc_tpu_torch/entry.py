"""Entry points of the port: one forward step of the flagship model, and the
multi-device dry run.

Counterparts of ``entry()`` and ``dryrun_multichip(n)`` in the
repository's ``__graft_entry__.py``:

* :func:`entry`: one batched adaptive-ARWMH transition (proposal matvec,
  MH accept, rank-1 Cholesky covariance adaptation through kernel K1) on
  the eight-schools posterior at 256 chains, on the card unless the caller
  asks for the CPU;
* :func:`dryrun_multichip`: the multi-device path on a chain mesh of n
  processes, one per device (``parallel``): each of the four samplers
  through ``run_mcmc_sharded`` at two mesh sizes, both collectives and a
  sharded ``sample_pnx``, once on tiny shapes.

    fn, (state,) = entry()
    state = fn(state)
    dryrun_multichip(2)                 # two cards, NCCL
    dryrun_multichip(4, device="cpu")   # four processes on the CPU, gloo
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# how long the dry run's processes wait for a peer inside a collective, and
# how long dryrun_multichip waits for them all
WORKER_TIMEOUT = datetime.timedelta(seconds=60)
DRYRUN_SECONDS = 120.0


def entry(device="cuda"):
    """``(fn, (state,))``: ``fn(state)`` is one ARWMH step of 256 chains on
    ``device``, drawing from a generator seeded 0 there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry() runs on the card by default and "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' for the plain versions")
    from adaptive_mcmc_tpu_torch import ARWMHConfig, arwmh, \
        eight_schools_noncentered

    kernel = arwmh(eight_schools_noncentered(), ARWMHConfig(num_warmup=0))
    generator = torch.Generator(device).manual_seed(0)
    state = kernel.init(generator, n_chains=256)

    def fn(state):
        return kernel.step(state, generator)

    return fn, (state,)


def mesh_sizes(n_devices: int) -> list:
    """The dry run's mesh sizes: the whole mesh, and half of it from four
    devices on, so that the sharded paths run at two device counts."""
    return [n_devices] + ([n_devices // 2] if n_devices >= 4 else [])


def free_tcp_address() -> str:
    """``tcp://127.0.0.1:<port>`` with a port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def run_workers(argv_of_rank, n: int, timeout: float, what: str) -> list:
    """Start ``n`` processes of this interpreter, ``argv_of_rank(r)`` each
    (from the repository's root, so that the package imports), and wait
    for all of them; returns their outputs (stdout and stderr together).
    Raises, after killing the rest, as soon as one exits non-zero, or when
    ``timeout`` seconds have passed."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(r)], cwd=root,
                              env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]

    def outputs() -> list:
        out = []
        for log in logs:
            log.seek(0)
            out.append(log.read())
            log.close()
        return out

    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = outputs()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        timed_out = time.monotonic() > deadline
        raise RuntimeError(
            f"{what}: process {bad[0]} of {n} "
            + (f"did not finish in {timeout:.0f} s" if timed_out
               else f"exited with code {procs[bad[0]].returncode}")
            + "\n" + "\n".join(f"--- process {r} ---\n{out[r][-4000:]}"
                               for r in bad))
    return out


def dryrun_multichip(n_devices: int, device="cuda", *, backend=None,
                     init_method=None) -> list:
    """The multi-device path on ``n_devices`` processes, one device each:
    ARWMH, ASSS, NUTS (``num_warmup=2``, ``max_tree_depth=3``) and SA
    (``num_warmup=2``) through ``run_mcmc_sharded`` at each of
    :func:`mesh_sizes` (2 chains a process), both collectives on each
    run's blocks, and a sharded seeded ``sample_pnx``; prints JAX's ok line
    and returns the processes' outputs.

    ``device="cuda"`` (the default) gives process r the card r modulo the
    card count, over NCCL (one card per process), or with
    ``backend="gloo"`` over gloo, which lets processes share a card; the
    CUDA kernels are built here first, and a process that would build one
    fails.  ``device="cpu"`` runs gloo on the CPU.  ``init_method`` is the
    rendezvous (``file://`` under a test runner), by default a free TCP
    port on localhost.  Each process starts by ``subprocess`` (never a
    fork of this one); one that fails, or a run longer than
    ``DRYRUN_SECONDS``, fails the run."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip runs on the card by default "
                               "and torch.cuda.is_available() is false; "
                               "pass device='cpu'")
        backend = backend or "nccl"
        if backend == "nccl" and n_devices > torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL takes one card per process: {n_devices} processes, "
                f"{torch.cuda.device_count()} cards (backend='gloo' lets "
                f"them share)")
        from adaptive_mcmc_tpu_torch.ops.cuda import _build

        _build.build("chol_update")
    else:
        backend = backend or "gloo"
    init_method = init_method or free_tcp_address()
    outs = run_workers(
        lambda r: ["-m", "adaptive_mcmc_tpu_torch.entry", "dryrun-worker",
                   str(r), str(n_devices), init_method, device.type,
                   backend],
        n_devices, DRYRUN_SECONDS, "dryrun_multichip")
    for r, out in enumerate(outs):
        if f"dryrun worker {r} ok" not in out:
            raise RuntimeError(f"dryrun_multichip: process {r} did not "
                               f"report ok:\n{out[-4000:]}")
    print(f"dryrun_multichip ok on {n_devices} devices (mesh sizes "
          f"{mesh_sizes(n_devices)}, incl. sharded sample_pnx)", flush=True)
    return outs


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def _dryrun_worker(rank: int, n: int, init_method: str, device_type: str,
                   backend: str) -> None:
    """Process ``rank`` of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from adaptive_mcmc_tpu_torch import (
        NUTSConfig,
        SAConfig,
        arwmh,
        asss,
        eight_schools_noncentered,
        nuts,
        sa,
    )
    from adaptive_mcmc_tpu_torch.infer.mcmc import (
        get_init_adapt_state,
        sample_pnx,
    )
    from adaptive_mcmc_tpu_torch.parallel import (
        chain_mesh,
        chain_sharding,
        cross_chain_moments,
        initialize_distributed,
        run_mcmc_sharded,
        sharded_gelman_rubin,
    )

    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    initialize_distributed(init_method, n, rank, device=dev,
                           backend=backend, timeout=WORKER_TIMEOUT)
    try:
        target = eight_schools_noncentered()
        d = target.dim
        builders = (
            arwmh,
            asss,
            lambda t: nuts(t, NUTSConfig(num_warmup=2, max_tree_depth=3)),
            lambda t: sa(t, SAConfig(num_warmup=2)),
        )
        for size in mesh_sizes(n):
            mesh = chain_mesh(size, devices=[dev])
            if not mesh.member:
                continue
            _require(mesh.size == size, f"mesh of {mesh.size}, not {size}")
            n_chains = 2 * size
            for build in builders:
                kernel = build(target)
                samples, extras, last = run_mcmc_sharded(
                    kernel, torch.Generator(dev).manual_seed(0),
                    num_warmup=2, num_samples=4, thinning=2,
                    n_chains=n_chains, mesh=mesh,
                    extra_fields=("potential_energy",))
                _require(tuple(samples.shape) == (2, n_chains, d)
                         and bool(torch.isfinite(samples).all()),
                         f"{kernel.name} at mesh size {size}: samples "
                         f"{tuple(samples.shape)}")
                _require(samples.device == dev, "draws left the device")
                # the collectives over the mesh, on this process's block
                rows = chain_sharding(mesh, n_chains)
                rhat = sharded_gelman_rubin(samples[:, rows], mesh)
                mean, var = cross_chain_moments(last.position, mesh)
                _require(rhat.shape == (d,) and mean.shape == (d,)
                         and var.shape == (d,), "collective shapes")
            # the sharded P^n(x, .) engine: (points x samples) flattened to
            # one chain axis split over the mesh
            kernel = arwmh(target)
            adapt = get_init_adapt_state(
                kernel, torch.Generator(dev).manual_seed(1), n_chains=size)
            out = sample_pnx(kernel, 2, torch.zeros(size, d, device=dev),
                             adapt, n=2, n_samples=4, mesh=mesh)
            _require(tuple(out.shape) == (size, 4, d)
                     and bool(torch.isfinite(out).all()),
                     f"sample_pnx at mesh size {size}: {tuple(out.shape)}")
        if device_type == "cuda":
            from adaptive_mcmc_tpu_torch.ops.cuda import _build

            _require(not _build.build_seconds,
                     f"process {rank} ran nvcc: {_build.build_seconds}")
        # every process reaches the end before any leaves the group
        dist.all_reduce(torch.ones(1, device=dev))
        print(f"dryrun worker {rank} ok", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["dryrun-worker"]:
        r, world, url, dtype, be = sys.argv[2:7]
        _dryrun_worker(int(r), int(world), url, dtype, be)
    else:
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print("entry ok" if bool(torch.isfinite(out.position).all())
              else "entry gave non-finite positions")
