"""Entry point of the port: one forward step of the flagship model.

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py``: one
batched adaptive-ARWMH transition (proposal matvec, MH accept, rank-1
Cholesky covariance adaptation through kernel K1) on the eight-schools
posterior at 256 chains, on the card unless the caller asks for the CPU.
The multi-device dry run waits for the port's ``parallel`` package.

    fn, (state,) = entry()
    state = fn(state)
"""

from __future__ import annotations

import torch


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


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok" if bool(torch.isfinite(out.position).all())
          else "entry gave non-finite positions")
