"""Checkpoint / resume of kernel states (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/utils/checkpoint.py``.  A kernel state
(a NamedTuple of tensors and NamedTuples) is the checkpoint: it holds
position, potential, adaptation and iteration counter.  It is saved as a
compressed npz of its tensors in field order, with a string that records
the structure; no pickle.  The port's states carry no PRNG key: a caller
that resumes a run saves its ``torch.Generator``'s state beside the state
(``infer/checkpointed.py`` does).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

# the module, not its names: infer.mcmc imports utils (the recorder) and
# may still be loading when this module is
from adaptive_mcmc_tpu_torch.infer import mcmc


def _structure(state: Any) -> str:
    """The nesting and field names of a state, ``*`` for a tensor."""
    if isinstance(state, torch.Tensor):
        return "*"
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return f"{type(state).__name__}(" + ", ".join(
            f"{f}={_structure(v)}" for f, v in zip(state._fields, state)
        ) + ")"
    raise TypeError(f"a state is a NamedTuple of tensors and NamedTuples, "
                    f"got {type(state).__name__}")


def save_state(path: str | Path, state: Any) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf_{i}": t.detach().cpu().numpy()
              for i, t in enumerate(mcmc.state_tensors(state))}
    np.savez_compressed(path, __structure__=np.array(_structure(state)),
                        **arrays)


def load_state(path: str | Path, like: Any) -> Any:
    """Restore a state saved by :func:`save_state`.  ``like`` (for example
    a freshly built init state of the same kernel and chain count) gives
    the structure, and each tensor's device and dtype."""
    with np.load(Path(path), allow_pickle=False) as data:
        saved = str(data["__structure__"])
        if saved != _structure(like):
            raise ValueError(f"{path} holds {saved}, not {_structure(like)}")
        leaves = iter([data[f"leaf_{i}"]
                       for i in range(len(mcmc.state_tensors(like)))])
    return mcmc.map_state(
        lambda t: torch.tensor(next(leaves), dtype=t.dtype, device=t.device),
        like)


class SweepManifest:
    """Per-item restartability for seed sweeps (the reference's
    skip-if-file-exists guard, generalized): records completed work units
    in a JSON manifest so interrupted sweeps resume where they stopped."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._done = set()
        if self.path.exists():
            self._done = set(json.loads(self.path.read_text()))

    def is_done(self, key: str) -> bool:
        return key in self._done

    def mark_done(self, key: str) -> None:
        self._done.add(key)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(sorted(self._done)))
