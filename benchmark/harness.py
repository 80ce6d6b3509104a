"""What every job kind shares: the run's context, seeds drawn from the
run's seed, the process's age, the card's description and the check that
no JAX module is loaded."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# top-level module names that a run of the port may not load: JAX and the
# JAX package (compared whole: the port's name begins with the latter)
FORBIDDEN = ("jax", "jaxlib", "flax", "adaptive_mcmc_tpu")

_T_IMPORT = time.monotonic()


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``), else since
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def job_seed(seed: int, k: int) -> int:
    """The seed of job ``k`` of a run (k = -1: the warm-up job), a 63-bit
    integer drawn from the run's seed."""
    words = np.random.SeedSequence([seed % 2**64, k + 1]).generate_state(
        2, np.uint32)
    return int((int(words[0]) << 31) ^ int(words[1])) % 2**63


def reference_seed(seed: int) -> int:
    """The seed of the run's reference sampler, apart from every job's."""
    return job_seed(seed, 2**40)


def seeded_choice(seed: int, first: int, count: int) -> set:
    """``count`` of the indices below ``first``, drawn from the seed: the
    jobs of a window that keep their outputs for the correctness check
    (the window's last job keeps them besides)."""
    rng = np.random.default_rng([seed % 2**64, 7])
    return {int(k) for k in rng.choice(first, size=min(count, first),
                                       replace=False)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


@dataclass
class Context:
    """One run: its cell, configuration, traffic, seed and device, and the
    work and spans its jobs count."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    device: object
    registry: object = None
    tmp_root: Path = field(default_factory=lambda: Path(
        os.environ.get("TMPDIR", "/tmp")))
    # work done, by unit (chain_iters, draws, sets, jobs), over the whole run
    work: dict = field(default_factory=dict)
    # seconds of the program's own spans, by name, over the window's jobs
    spans: dict = field(default_factory=dict)
    # the timed window's work and spans; the traced window's work and its
    # trace's summary
    window_work: dict = field(default_factory=dict)
    window_spans: dict = field(default_factory=dict)
    traced_work: dict = field(default_factory=dict)
    trace: object = None

    def count(self, unit: str, n: float) -> None:
        self.work[unit] = self.work.get(unit, 0) + n

    def span(self, name: str, seconds: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + seconds
