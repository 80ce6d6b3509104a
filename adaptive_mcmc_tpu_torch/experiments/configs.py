"""Config layer for the experiment harness (PyTorch port).

The port's own copy of ``adaptive_mcmc_tpu/experiments/configs.py``, with
the same fields, budgets and JSON, so that a config written by either
package loads in the other.  The reference has no config system — env vars + hardcoded per-script dicts
(run_eight_schools_wasserstein.py:60-67, SURVEY §5).  Here one frozen
dataclass drives every sweep, JSON-serializable for reproducibility.

The canonical iteration budgets below mirror the reference's w_eval sweeps
(each kernel tuned to yield 10k thinned draws per seed)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple


# the root of the port's outputs: its own, apart from mcmc_runs/w_eval and
# mcmc_runs/lr_decay, where the JAX package keeps its committed evidence
# (a default run there would skip on the reference's manifests or write
# over its files); git ignores it
OUT_ROOT = "mcmc_runs/torch"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    target: str                       # "eight_schools" | "diamonds" | "kidiq" | ...
    kernel: str                       # "arwmh" | "asss" | "nuts" | "rwm" | "sa"
    num_warmup: int
    num_samples: int
    thinning: int = 1
    lr_decay: float = 2.0 / 3.0
    n_seeds: int = 100                # seeds run as one batched chain axis
    chains_per_seed: int = 1
    fan_out: int = 1                  # post-warmup clones per chain (see
                                      # parallel.run.fan_state)
    seed0: int = 0
    mesh_devices: Optional[int] = None  # None = every process of the
                                        # process group (one without one)
    out_dir: str = OUT_ROOT
    fused: Optional[bool] = None      # ARWMH/ASSS through K2/K3 (True), the
                                      # lockstep/machine (False), or the
                                      # kernels' own pick (None)

    def to_json(self) -> str:
        # ``fused`` is the port's field: left out at its default, so that
        # such a config's JSON is the JAX package's, byte for byte
        d = dataclasses.asdict(self)
        if d["fused"] is None:
            del d["fused"]
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "RunConfig":
        return RunConfig(**json.loads(s))

    def run_name(self) -> str:
        return f"{self.target}/{self.kernel}"


# Reference iteration budgets (run_*_wasserstein.py __main__ blocks).
W_EVAL_BUDGETS = {
    ("eight_schools", "arwmh"): dict(num_warmup=50_000, num_samples=500_000, thinning=50),
    ("eight_schools", "asss"): dict(num_warmup=25_000, num_samples=250_000, thinning=25),
    ("eight_schools", "nuts"): dict(num_warmup=10_000, num_samples=100_000, thinning=10),
    ("diamonds", "arwmh"): dict(num_warmup=1_000_000, num_samples=10_000_000, thinning=1000),
    ("diamonds", "asss"): dict(num_warmup=500_000, num_samples=5_000_000, thinning=500),
    ("diamonds", "nuts"): dict(num_warmup=1_000, num_samples=10_000, thinning=1),
    ("kidiq", "arwmh"): dict(num_warmup=10_000, num_samples=100_000, thinning=10),
    ("kidiq", "asss"): dict(num_warmup=10_000, num_samples=100_000, thinning=10),
    ("kidiq", "nuts"): dict(num_warmup=1_000, num_samples=10_000, thinning=1),
    # The reference exposes SA only as a kernel baseline (numpyro_kernels.py:
    # 16-73), never in a w_eval sweep; this cell gives the fourth kernel a
    # quality row under the ASSS eight-schools budget (our own choice).
    ("eight_schools", "sa"): dict(num_warmup=25_000, num_samples=250_000, thinning=25),
}

LR_DECAYS = (1.0, 2.0 / 3.0, 0.5)


def w_eval_config(target: str, kernel: str, **overrides) -> RunConfig:
    budget = dict(W_EVAL_BUDGETS[(target, kernel)])
    budget.update(overrides)
    return RunConfig(target=target, kernel=kernel, **budget)
