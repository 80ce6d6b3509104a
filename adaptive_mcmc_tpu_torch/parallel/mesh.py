"""The chain mesh of a chain-parallel run (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/parallel/mesh.py``.  The JAX package
shards the chain axis over a 1-D ``chains`` mesh and one program (GSPMD)
runs every device's block.  The port runs one process per device, as
torchrun does: each process holds one device and its block of the chain
axis, and the processes meet in a ``torch.distributed`` process group (NCCL
between CUDA devices, gloo on the CPU).  Chains are independent, so a step
needs no communication; collectives run only where draws are gathered and
where the diagnostics reduce their partial sums (``parallel.run``).

A process with no process group holds a one-device mesh, as before: the
process's CUDA device, or the device it names (``devices=["cpu"]``).
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

CHAIN_AXIS = "chains"
# how long the rendezvous or a collective waits for a peer before it fails:
# a run's blocks may end minutes apart, and its gather waits for the last
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
_SEED_MASK = 2**63 - 1


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """This process's view of a 1-D chain mesh: its ``device``, the process
    ``group`` the mesh's collectives run in (None for a mesh of one),
    the mesh's ``size`` and this process's ``rank`` in it, and whether the
    process is a ``member`` (a sub-mesh leaves the higher ranks out).
    ``ChainMesh(device)`` is a one-device mesh of this process alone."""

    device: torch.device
    group: Any = None
    size: int = 1
    rank: int = 0
    member: bool = True


def _launch_advice(n: int) -> str:
    return (f"a chain mesh of {n} devices runs one process per device: "
            f"launch with `torchrun --nproc-per-node {n} ...` (or call "
            f"parallel.initialize_distributed in each process) before "
            f"building it")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None, backend: Optional[str] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Join this process to the process group of a multi-process run, once
    per process, before the first collective; returns its device, or None
    where there is one process and no ``coordinator_address`` (a no-op;
    with an address, one process forms a group of one).

    ``num_processes`` defaults to ``MCMC_NUM_PROCESSES``, else torchrun's
    ``WORLD_SIZE``, else 1; ``process_id`` to torchrun's ``RANK``;
    ``coordinator_address`` (``host:port``, or a URL such as
    ``file:///path`` or ``tcp://host:port``) to torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).  ``device`` defaults to
    the CUDA device of index ``LOCAL_RANK`` (else ``process_id``), made
    current before the first CUDA call; there is no default without CUDA:
    pass ``device="cpu"``.  ``backend`` defaults to NCCL for a CUDA device
    and gloo for the CPU (gloo also takes CUDA tensors, which lets several
    processes share one card, as NCCL does not).  A peer that is lost
    fails the rendezvous or the collective after ``timeout``."""
    if num_processes is None:
        num_processes = int(os.environ.get("MCMC_NUM_PROCESSES")
                            or os.environ.get("WORLD_SIZE") or "1")
    if num_processes <= 1 and coordinator_address is None:
        return None
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: this process already "
                           "belongs to a process group")
    if process_id is None and num_processes == 1:
        process_id = 0
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("initialize_distributed: no process_id and no "
                             "RANK in the environment (torchrun sets it)")
        process_id = int(os.environ["RANK"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device; "
                               "pass device='cpu' for a run on the CPU")
        index = int(os.environ.get("LOCAL_RANK", process_id))
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"initialize_distributed: process {process_id} wants CUDA "
                f"device {index}, and there are "
                f"{torch.cuda.device_count()}")
        device = torch.device("cuda", index)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=timeout,
        device_id=device if backend == "nccl" else None)
    return device


def process_device(devices: Optional[Sequence] = None) -> torch.device:
    """This process's device: the one of ``devices`` (a list of one), else
    its current CUDA device; raises where there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name one, e.g. "
                               "chain_mesh(devices=['cpu'])")
        return torch.device("cuda", torch.cuda.current_device())
    devices = [torch.device(d) for d in devices]
    if len(devices) != 1:
        raise ValueError(
            f"devices={devices}: a process holds one device of the mesh; "
            + _launch_advice(len(devices)))
    device = devices[0]
    if device.type == "cuda" and device.index is None:
        # as a generator or a tensor made on "cuda" names it
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def chain_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> ChainMesh:
    """The chain mesh over the first ``n_devices`` processes of the process
    group (all of them by default), on this process's device: the one of
    ``devices`` (a list of one), else its current CUDA device; raises
    ``RuntimeError`` where there is no CUDA device and none was named.

    With no process group it is a one-device mesh; ``n_devices`` > 1 then
    raises and says how to launch.  A sub-mesh (``n_devices`` below the
    group's size) creates a process group, which is collective over every
    process: each one calls ``chain_mesh`` with the same ``n_devices`` in
    the same order, members or not, or the run hangs."""
    device = process_device(devices)
    if not dist.is_initialized():
        if n_devices is not None and n_devices > 1:
            raise RuntimeError(_launch_advice(n_devices))
        return ChainMesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices in a process group of "
                         f"{world}")
    if n == world:
        group = dist.group.WORLD
    elif n > 1:
        group = dist.new_group(list(range(n)))
    else:
        group = None
    return ChainMesh(device, group, n, rank, rank < n)


def chain_sharding(mesh: ChainMesh, n_chains: int) -> slice:
    """The rows of a (n_chains, ...) chain axis this process holds:
    contiguous blocks, rank-major (JAX: ``NamedSharding(mesh,
    P("chains"))``)."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not on this mesh of "
                         f"{mesh.size}")
    if n_chains % mesh.size:
        raise ValueError(f"n_chains ({n_chains}) must be a multiple of the "
                         f"mesh size ({mesh.size})")
    b = n_chains // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def replicated(mesh: ChainMesh) -> torch.device:
    """Where this process keeps a value every process holds whole (JAX:
    ``NamedSharding(mesh, P())``): its device."""
    return mesh.device


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s stream in a run seeded ``seed``:
    ``seed`` itself on rank 0, else the first 63 bits of the SHA-256 of
    ``"<seed>:<rank>"`` (little-endian)."""
    if rank == 0:
        return seed
    digest = hashlib.sha256(f"{seed}:{rank}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & _SEED_MASK


def rank_generator(generator: torch.Generator,
                   rank: int) -> torch.Generator:
    """Rank ``rank``'s generator of a run handed ``generator``: on rank 0
    ``generator`` itself, so that a one-rank mesh draws exactly what one
    process draws; on rank r > 0 a new generator on its device seeded
    :func:`rank_seed` (s, r), where s is the first 63 bits of the SHA-256
    of ``generator.get_state()`` (for a fresh generator, a function of its
    seed)."""
    if rank == 0:
        return generator
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()).digest()
    seed = int.from_bytes(digest[:8], "little") & _SEED_MASK
    return torch.Generator(generator.device).manual_seed(
        rank_seed(seed, rank))
