"""Target densities as batched flat-vector potential functions (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/models/base.py``.  A :class:`Target`
carries a hand-written *unconstrained-space* potential over a batch of flat
vectors: ``potential_fn(x)`` takes ``(C, dim)`` and returns ``(C,)``, where
the JAX package vmaps a per-chain ``(dim,) -> ()`` function.  Site metadata
and the constrain/unconstrain maps are the same as on the JAX side, so
trajectories are index-compatible between the two packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Metadata for one latent site in the flat unconstrained vector."""

    name: str
    size: int                       # number of flat entries
    shape: Tuple[int, ...]          # constrained-space shape
    transform: str = "identity"     # "identity" | "exp" (support -> (0, inf))


@dataclasses.dataclass(frozen=True)
class Target:
    """A target posterior as a batched flat unconstrained-space density.

    ``potential_fn``: ``(C, dim) -> (C,)`` negative log-density including
    the log-Jacobian of the unconstraining transforms.  ``data`` holds the
    arrays the potential was built from, with a copy per device.
    ``device_potential`` names the ``__device__`` potential of
    ``csrc/common.cuh`` that computes exactly ``potential_fn`` (same
    operations, same order), or is None: only a tagged target runs in the
    fused CUDA sweeps, which read its ``data["kernel_data"]``.
    """

    name: str
    dim: int
    potential_fn: Callable[[Tensor], Tensor]
    sites: Tuple[SiteSpec, ...] = ()
    data: Any = None
    device_potential: Optional[str] = None

    def log_prob(self, x: Tensor) -> Tensor:
        return -self.potential_fn(x)

    # ---- site packing -------------------------------------------------
    def _offsets(self) -> Sequence[Tuple[SiteSpec, int]]:
        out, off = [], 0
        for s in self.sites:
            out.append((s, off))
            off += s.size
        return out

    def constrain(self, x: Tensor) -> dict:
        """Map flat unconstrained vectors ``(..., dim)`` to the constrained
        per-site dict."""
        out = {}
        for s, off in self._offsets():
            v = x[..., off: off + s.size]
            v = v.reshape(x.shape[:-1] + s.shape) if s.shape else v[..., 0]
            if s.transform == "exp":
                v = torch.exp(v)
            out[s.name] = v
        return out

    def unconstrain(self, sites: Mapping[str, Any]) -> Tensor:
        """Inverse of :meth:`constrain` (batch dims allowed)."""
        parts = []
        for s, _ in self._offsets():
            v = sites[s.name]
            v = v.to(torch.float32) if isinstance(v, Tensor) else \
                torch.tensor(np.asarray(v, np.float32))
            if s.transform == "exp":
                v = torch.log(v)
            b = v.shape[: v.dim() - len(s.shape)]
            parts.append(v.reshape(tuple(b) + (s.size,)))
        return torch.cat(parts, dim=-1)

    def init_position(self, generator: torch.Generator, n_chains: int = 1,
                      radius: float = 2.0) -> Tensor:
        """Uniform(-radius, radius) init in unconstrained space, one row per
        chain, on the generator's device (``init_to_uniform``)."""
        u = torch.rand((n_chains, self.dim), generator=generator,
                       device=generator.device, dtype=torch.float32)
        return u * (2.0 * radius) - radius


class DeviceConstants:
    """float32 copies of a target's numpy data, one per device, so that a
    potential runs on whatever device its input lives on without a host
    copy per call."""

    def __init__(self, **arrays: np.ndarray):
        self._np = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
        self._by_device: dict = {}

    def on(self, device: torch.device) -> dict:
        key = str(device)
        if key not in self._by_device:
            self._by_device[key] = {
                k: torch.as_tensor(v, device=device)
                for k, v in self._np.items()
            }
        return self._by_device[key]


# ---------------------------------------------------------------------------
# Shared unconstrained-space log-density building blocks (fp32, NaN-safe).
# ---------------------------------------------------------------------------

_LOG_2 = 0.6931471805599453
_LOG_PI = 1.1447298858494002
_LOG_2PI = 1.8378770664093453


def _log(v):
    return torch.log(v) if isinstance(v, Tensor) else math.log(v)


def sum_in_order(a: Tensor, dim: int = -1) -> Tensor:
    """Sum over ``dim`` one slice at a time, left to right: the order the
    fused CUDA kernels sum in, so that kernel and plain version round
    alike."""
    s = a.select(dim, 0)
    for k in range(1, a.shape[dim]):
        s = s + a.select(dim, k)
    return s


def sum_strided(a: Tensor, lanes: int) -> Tensor:
    """Sum over the last axis as ``lanes`` running sums, entry n going to
    sum n mod ``lanes`` (each summed left to right from 0), then those sums
    left to right: the order of the fused CUDA kernels' long data sums
    (``csrc/common.cuh``), in ``lanes`` + N / ``lanes`` slice additions
    rather than N."""
    pad = (-a.shape[-1]) % lanes
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
    blocks = a.reshape(a.shape[:-1] + (-1, lanes))
    return sum_in_order(sum_in_order(blocks, -2), -1)


def normal_logpdf(x, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - _log(scale)


def half_cauchy_logpdf(x, scale):
    """log p(x) for x >= 0: 2 / (pi * scale * (1 + (x/scale)^2))."""
    z = x / scale
    return _LOG_2 - _LOG_PI - _log(scale) - torch.log1p(z * z)


def student_t_logpdf(x, df, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    half = 0.5 * (df + 1.0)
    return (
        math.lgamma(half) - math.lgamma(0.5 * df)
        - 0.5 * math.log(df) - 0.5 * _LOG_PI - _log(scale)
        - half * torch.log1p(z * z / df)
    )


def folded_student_t_logpdf(x, df, loc=0.0, scale=1.0):
    """log p(|T|) for T ~ StudentT(df, loc, scale), x >= 0."""
    return torch.logaddexp(
        student_t_logpdf(x, df, loc, scale),
        student_t_logpdf(-x, df, loc, scale),
    )
