"""Faults planted in the port underneath a run, to show that ``correct``
catches them: each is a context manager that swaps a factory of the
program for one whose product is broken, and restores it on exit.

Sampling (``kernels.arwmh``, ``kernels.asss``, as the harness and
``MCMC`` reach them):

* ``unchanged``: every transition returns its state unchanged;
* ``half``: the second half of the chains is never stepped;
* ``altered``: one draw's position is altered where it is produced (its
  potential is left as it was).

Grading (``metrics.assignment.auction_assignment_batch``, as
``evaluate_run`` reaches it):

* ``unchanged``: the auction returns the assignment it starts from (each
  row to the column of its own index);
* ``half``: the second half of each batch keeps that assignment;
* ``altered``: one instance's assignment is shifted by one column."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

FAULTS = ("unchanged", "half", "altered")


def _merge(new, old, h: int, C: int):
    """``new`` for the first ``h`` chains, ``old`` for the rest."""
    import torch

    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_merge(a, b, h, C) for a, b in zip(new, old)))
    if isinstance(new, torch.Tensor) and new.dim() >= 1 and \
            new.shape[0] == C:
        return torch.cat([new[:h], old[h:]])
    return new


def broken_kernel(kernel, fault: str):
    """``kernel`` with ``fault`` planted in its transitions."""
    step, step_n, collect_n = kernel.step, kernel.step_n, kernel.collect_n
    fields = kernel.collect_fields

    def frames_of(state, F: int) -> dict:
        return {f: getattr(state, f)[:, None].expand(
            (-1, F) + tuple(getattr(state, f).shape[1:])).clone()
            for f in fields}

    if fault == "unchanged":
        def new_step(state, *a, **k):
            return state

        def new_step_n(state, n, *a, **k):
            return state

        def new_collect_n(state, F, thinning=1, *a, **k):
            return state, frames_of(state, F)
    elif fault == "half":
        def half(state):
            C = state.position.shape[0]
            return C // 2, C

        def new_step(state, *a, **k):
            return _merge(step(state, *a, **k), state, *half(state))

        def new_step_n(state, n, *a, **k):
            return _merge(step_n(state, n, *a, **k), state, *half(state))

        def new_collect_n(state, F, thinning=1, *a, **k):
            import torch

            h, C = half(state)
            new, frames = collect_n(state, F, thinning, *a, **k)
            old = frames_of(state, F)
            return _merge(new, state, h, C), {
                f: torch.cat([frames[f][:h], old[f][h:]]) for f in frames}
    elif fault == "altered":
        def new_step(state, *a, **k):
            out = step(state, *a, **k)
            pos = out.position.clone()
            pos[0, 0] += 1.0
            return out._replace(position=pos)

        new_step_n = step_n

        def new_collect_n(state, F, thinning=1, *a, **k):
            new, frames = collect_n(state, F, thinning, *a, **k)
            frames["position"][0, -1, 0] += 1.0
            return new, frames
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return dataclasses.replace(
        kernel, step=new_step,
        step_n=None if step_n is None else new_step_n,
        collect_n=None if collect_n is None else new_collect_n,
        graph_step=False, step_parts=None)


@contextlib.contextmanager
def sample_fault(fault: str):
    """Plant ``fault`` in every ARWMH and ASSS kernel built inside."""
    amt = importlib.import_module("adaptive_mcmc_tpu_torch")
    kernels = importlib.import_module("adaptive_mcmc_tpu_torch.kernels")
    saved = {name: getattr(kernels, name) for name in ("arwmh", "asss")}

    def wrap(factory):
        return lambda *a, **k: broken_kernel(factory(*a, **k), fault)

    try:
        for name, factory in saved.items():
            setattr(kernels, name, wrap(factory))
            setattr(amt, name, wrap(factory))
        yield
    finally:
        for name, factory in saved.items():
            setattr(kernels, name, factory)
            setattr(amt, name, factory)


@contextlib.contextmanager
def grade_fault(fault: str):
    """Plant ``fault`` in the batched auction."""
    import torch

    assignment = importlib.import_module(
        "adaptive_mcmc_tpu_torch.metrics.assignment")
    solve = assignment.auction_assignment_batch

    def broken(costs, *a, **k):
        out = solve(costs, *a, **k)
        cols, prices = out if k.get("return_prices") else (out, None)
        B, n = cols.shape
        start = torch.arange(n, device=cols.device).expand(B, n)
        if fault == "unchanged":
            cols = start.clone()
        elif fault == "half":
            cols = torch.cat([cols[:B // 2], start[B // 2:]])
        elif fault == "altered":
            cols = cols.clone()
            cols[0] = torch.roll(cols[0], 1)
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return (cols, prices) if k.get("return_prices") else cols

    assignment.auction_assignment_batch = broken
    try:
        yield
    finally:
        assignment.auction_assignment_batch = solve


def plant(kind: str, fault: str):
    """The fault context of a job kind."""
    return sample_fault(fault) if kind == "sample" else grade_fault(fault)
