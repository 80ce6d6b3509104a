"""The device a chain-parallel run lives on (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/parallel/mesh.py``.  The JAX package
shards the chain axis over a 1-D ``chains`` mesh of every local device;
chains are independent, so a step needs no communication.  The port runs
one process on one device: :func:`chain_mesh` returns that device (the
process's CUDA device by default, or the CPU when asked), and a mesh of
more than one device, like a multi-process :func:`initialize_distributed`,
waits for torch.distributed (ROADMAP A15) and raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

CHAIN_AXIS = "chains"

_A15 = ("a chain mesh over several devices or processes needs "
        "torch.distributed, which the port does not have yet (ROADMAP A15)")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-process bootstrap: a no-op for one process (the default, or
    ``MCMC_NUM_PROCESSES=1``); more raises ``NotImplementedError``."""
    if num_processes is None:
        num_processes = int(os.environ.get("MCMC_NUM_PROCESSES", "1"))
    if num_processes > 1:
        raise NotImplementedError(_A15)


def chain_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> torch.device:
    """The one device of the chain axis: the first of ``devices``, else the
    process's current CUDA device.  ``devices=["cpu"]`` runs on the CPU.
    Raises ``NotImplementedError`` for more than one device and
    ``RuntimeError`` where no CUDA device is present and none was named."""
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(_A15)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name one, e.g. "
                               "chain_mesh(devices=['cpu'])")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if len(devices) != 1:
        raise NotImplementedError(_A15)
    return devices[0]
