"""The port's benchmark: batched adaptive MCMC on one CUDA card.

    python -m adaptive_mcmc_tpu_torch.bench

Counterpart of the repository's ``bench.py``, with its five cells, chain
counts, step counts and each kernel's default config: ARWMH on eight
schools at 4096 chains (the lockstep step through K1, replayed from a CUDA
graph), ASSS on eight schools at 4096 chains and on diamonds at 1024 (the
pipelined machine, K1 chains last), SA on eight schools at 1024 chains
(three K1 launches per step, from a CUDA graph) and NUTS, which is not
ported yet and prints ``null``.  A cell times ``n_blocks`` blocks of
``timed_steps`` steps after one warm run of ``warmup_steps`` and one
untimed block, on the host clock closed by ``torch.cuda.synchronize()``.

Prints one JSON line: ``bench.py``'s fields plus ``card`` (nvidia-smi's
name and power limit).  ``vs_baseline`` divides by the reference's
single-chain laptop-CPU rates (BASELINE.md), copied here.  ``ess_per_sec``
is ``null``: the JAX bench reads it from the TPU sweeps, and no sweep has
run on the card yet.  A cell that fails ends the bench with its error;
nothing is retried and no file is written.  ``AMT_PROFILE_DIR`` set writes
a torch.profiler trace of the timed cells there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

# Reference rates (single chain, the author's laptop CPU; BASELINE.md),
# copied from bench.py.
BASE_ARWMH_ES = 55_700.0   # eight-schools ARWMH, ipynb cell 28
BASE_ASSS_ES = 42_400.0    # eight-schools ASSS, cell 29
BASE_NUTS_ES = 10_400.0    # eight-schools NUTS, cell 27
BASE_ASSS_DIAMONDS = 3_672.0  # diamonds ASSS, diamonds ipynb cell 51
# The reference never records an SA rate; bench.py divides by the JAX
# package's own single-chain CPU SA rate (scripts/sa_cpu_baseline.py).
BASE_SA_CPU = 9_112.9
# lockstep steps per CUDA graph replay; divides every cell's step counts
BLOCK = 50


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_kernel(kernel, n_chains: int, *, warmup_steps: int,
                timed_steps: int, n_blocks: int = 3, accept_field=None,
                device="cuda") -> float:
    """Steady-state chain-iters/s: one warm run of ``warmup_steps`` (it
    builds the kernels and captures the graph), one untimed block, then
    ``n_blocks`` timed blocks of ``timed_steps``."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import advancer

    if warmup_steps % BLOCK or timed_steps % BLOCK:
        raise ValueError(f"step counts must divide by {BLOCK}")
    generator = torch.Generator(device).manual_seed(0)
    state = kernel.init(generator, n_chains=n_chains)
    advance = advancer(kernel, generator, state, BLOCK)
    state = advance(state, warmup_steps)
    state = advance(state, timed_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        state = advance(state, timed_steps)
    torch.cuda.synchronize()
    rate = n_chains * timed_steps * n_blocks / (time.perf_counter() - t0)
    if accept_field is not None:
        accept = float(torch.mean(getattr(state, accept_field)))
        if not 0.05 < accept < 0.99:
            print(f"WARNING: {kernel.name} acceptance {accept:.3f} "
                  f"out of range", file=sys.stderr)
    return rate


def assemble(rates: dict, card: str) -> dict:
    """The JSON line from the measured rates (chain-iters/s by cell name;
    a rate of ``None`` is a cell not ported yet)."""

    def cell(metric: str, rate, base: float) -> dict:
        out = {"metric": metric,
               "value": None if rate is None else round(rate, 1),
               "unit": "chain_iters_per_sec",
               "vs_baseline": None if rate is None else round(rate / base, 2),
               "ess_per_sec": None}
        if rate is None:
            out["note"] = "not ported yet (ROADMAP A11)"
        return out

    extras = [
        cell("asss_eight_schools_4096chains", rates["asss"], BASE_ASSS_ES),
        cell("nuts_eight_schools_1024chains", rates["nuts"], BASE_NUTS_ES),
        cell("asss_diamonds_1024chains", rates["asss_diamonds"],
             BASE_ASSS_DIAMONDS),
        dict(cell("sa_eight_schools_1024chains", rates["sa"], BASE_SA_CPU),
             baseline_note="no reference-recorded SA rate exists; "
                           "denominator is the JAX package's own "
                           "single-chain CPU SA rate (9,113 it/s, "
                           "scripts/sa_cpu_baseline.py) — each SA "
                           "chain-iter updates a 102-point ensemble"),
    ]
    return {
        **cell("arwmh_eight_schools_4096chains", rates["arwmh"],
               BASE_ARWMH_ES),
        "ess_note": "ess_per_sec is null until the w_eval sweeps run on "
                    "the card (ROADMAP A14)",
        "card": card,
        "extras": extras,
    }


def main(device="cuda") -> dict:
    """Time the cells on ``device`` (a CUDA device), print the JSON line
    and return it."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the bench times a CUDA card; torch.cuda."
                           "is_available() is false or the device is not "
                           "CUDA")
    import adaptive_mcmc_tpu_torch as amt
    from adaptive_mcmc_tpu_torch.utils import trace

    es = amt.eight_schools_noncentered()
    diamonds = amt.diamonds()
    card = card_name()
    with trace(os.environ.get("AMT_PROFILE_DIR")):
        rates = {
            "arwmh": time_kernel(
                amt.arwmh(es, amt.ARWMHConfig(num_warmup=0)), 4096,
                warmup_steps=1000, timed_steps=1000, n_blocks=5,
                accept_field="mean_accept_prob", device=device),
            "asss": time_kernel(
                amt.asss(es, amt.ASSSConfig(num_warmup=0)), 4096,
                warmup_steps=500, timed_steps=500, device=device),
            "nuts": None,
            "asss_diamonds": time_kernel(
                amt.asss(diamonds, amt.ASSSConfig(num_warmup=0)), 1024,
                warmup_steps=300, timed_steps=300, device=device),
            "sa": time_kernel(
                amt.sa(es, amt.SAConfig()), 1024,
                warmup_steps=300, timed_steps=300, device=device),
        }
    result = assemble(rates, card)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
