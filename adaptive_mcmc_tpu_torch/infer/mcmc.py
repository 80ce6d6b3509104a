"""MCMC driver (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/infer/mcmc.py``: ``run_mcmc`` runs the
warmup, then a thinned collection into preallocated ``(num_collect, C, ...)``
buffers, so the unthinned draws never exist in memory.  Kernels with a
``step_n`` driver (ASSS, fused ARWMH) advance through it, and kernels with a
``collect_n`` driver (ASSS, fused ARWMH) record the frames inside it
instead.  PyTorch runs eagerly, so the loop over steps is a
Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

Tensor = torch.Tensor

_KERNEL_FACTORIES: dict = {}
# kernels whose step_n / step take injected ``noise`` / ``unif`` draws
_NOISE_UNIF_KERNELS = ("arwmh", "rwm")


def register_kernel_factory(name: str, factory: Callable) -> None:
    _KERNEL_FACTORIES[name] = factory


def run_mcmc(
    kernel,
    generator: Optional[torch.Generator],
    num_warmup: int,
    num_samples: int,
    *,
    thinning: int = 1,
    n_chains: int = 1,
    init_position=None,
    extra_fields: Sequence[str] = (),
    init_state=None,
    noise: Optional[Tensor] = None,
    unif: Optional[Tensor] = None,
    device=None,
):
    """Run ``num_warmup`` burn-in + ``num_samples`` sampling iterations.

    Returns ``(samples, extras, last_state)`` where ``samples`` has shape
    (num_samples // thinning, chains, dim) in *unconstrained* space and
    ``extras`` maps each requested state field to its thinned trajectory.
    ``noise`` (T, C, d) and ``unif`` (T, C), with T = num_warmup +
    num_samples, replace the generator's draws step for step; only ARWMH
    and RWM take them (ASSS replays go through its ``step``).
    """
    if num_samples % thinning:
        raise ValueError("num_samples must divide by thinning")
    num_collect = num_samples // thinning
    sample_field = kernel.sample_field
    fields = (sample_field, *extra_fields)
    collect_n = kernel.collect_n
    if collect_n is not None and not set(fields) <= set(kernel.collect_fields):
        collect_n = None

    state = (
        kernel.init(generator, n_chains=n_chains, position=init_position,
                    device=device)
        if init_state is None else init_state
    )
    total = num_warmup + num_samples
    if (noise is None) != (unif is None):
        raise ValueError("pass both noise and unif, or neither")
    if noise is not None:
        if kernel.name not in _NOISE_UNIF_KERNELS:
            raise ValueError(
                f"run_mcmc replays injected noise/unif only for "
                f"{_NOISE_UNIF_KERNELS}; kernel {kernel.name!r} takes its "
                f"injected draws through its own step")
        if noise.shape[0] != total or unif.shape[0] != total:
            raise ValueError(f"injected draws must cover {total} steps")

    def draws(t0: int, n: int) -> tuple:
        if noise is None:
            return ()
        return noise[t0:t0 + n], unif[t0:t0 + n]

    def advance(state, t0: int, n: int):
        if kernel.step_n is not None:
            return kernel.step_n(state, n, generator, *draws(t0, n))
        for t in range(t0, t0 + n):
            state = kernel.step(state, generator,
                                *(a[0] for a in draws(t, 1)))
        return state

    if num_warmup:
        state = advance(state, 0, num_warmup)

    if collect_n is not None:
        state, bufs = collect_n(state, num_collect, thinning, generator,
                                *draws(num_warmup, num_samples))
        samples = bufs[sample_field].transpose(0, 1)
        extras = {f: bufs[f].transpose(0, 1) for f in extra_fields}
        return samples, extras, state

    bufs = {
        f: torch.empty((num_collect,) + tuple(getattr(state, f).shape),
                       dtype=getattr(state, f).dtype,
                       device=getattr(state, f).device)
        for f in fields
    }
    for k in range(num_collect):
        state = advance(state, num_warmup + k * thinning, thinning)
        for f in fields:
            bufs[f][k] = getattr(state, f)
    samples = bufs.pop(sample_field)
    return samples, bufs, state


class MCMC:
    """Convenience driver (``MCMC(kernel, num_warmup, num_samples,
    thinning, n_chains)`` -> ``.run(generator)`` -> ``.get_samples()`` /
    ``.print_summary()``), built on :func:`run_mcmc`."""

    def __init__(self, kernel, *, num_warmup: int, num_samples: int,
                 thinning: int = 1, n_chains: int = 1):
        self.kernel = kernel
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.thinning = thinning
        self.n_chains = n_chains
        self._samples = None
        self._extras = None
        self.last_state = None

    def run(self, generator: torch.Generator, *, init_position=None,
            extra_fields: Sequence[str] = (), device=None):
        # Rebuild the kernel with the driver's warmup count so the
        # adaptation clock resets at the warmup boundary.
        kernel = self.kernel
        if hasattr(kernel.config, "num_warmup") and (
            kernel.config.num_warmup != self.num_warmup
        ):
            factory = _KERNEL_FACTORIES.get(kernel.name)
            if factory is not None:
                cfg = dataclasses.replace(
                    kernel.config, num_warmup=self.num_warmup
                )
                kernel = factory(kernel.target, cfg)
                self.kernel = kernel
            elif getattr(kernel.config, "adapt", True):
                raise ValueError(
                    f"kernel {kernel.name!r} has no registered factory; "
                    f"build it with num_warmup={self.num_warmup} yourself"
                )
            # non-adaptive kernels (e.g. rwm): the warmup clock only
            # normalizes mean_accept_prob — safe to keep as built
        self._samples, self._extras, self.last_state = run_mcmc(
            kernel,
            generator,
            self.num_warmup,
            self.num_samples,
            thinning=self.thinning,
            n_chains=self.n_chains,
            init_position=init_position,
            extra_fields=extra_fields,
            device=device,
        )
        return self

    # -- accessors ------------------------------------------------------
    def get_samples(self, *, group_by_chain: bool = False,
                    flat_unconstrained: bool = False):
        """Constrained per-site samples; by default (draws, chains) are
        flattened into one leading axis."""
        if self._samples is None:
            raise RuntimeError("call .run() first")
        x = self._samples  # (T, C, d)
        if not group_by_chain:
            x = x.reshape((-1,) + tuple(x.shape[2:]))
        if flat_unconstrained:
            return x
        return self.kernel.target.constrain(x)

    def get_extra_fields(self):
        return self._extras

    def print_summary(self):
        from adaptive_mcmc_tpu_torch.infer.diagnostics import summary_table

        print(summary_table(self.kernel.target, self._samples))

    def diagnostics_str(self) -> str:
        """Progress diagnostics: the acceptance rate (and step size) of
        states that carry them, otherwise the iteration and the mean
        potential energy (ASSS)."""
        s = self.last_state
        if hasattr(s, "mean_accept_prob"):
            ap = float(torch.mean(s.mean_accept_prob))
            a = getattr(s, "adapt_state", None)
            if hasattr(a, "log_step_size"):
                ss = float(torch.mean(torch.exp(a.log_step_size)))
                return f"Acceptance rate: {ap:.2f}, Step size: {ss:.3f}"
            return f"Acceptance rate: {ap:.2f}"
        return (f"Iteration: {int(s.i)}, Potential Energy: "
                f"{float(torch.mean(s.potential_energy)):.2f}")


def get_init_adapt_state(kernel, generator, position=None,
                         n_chains: int = 1):
    """Adapt state right after init."""
    return kernel.init(generator, n_chains=n_chains,
                       position=position).adapt_state
