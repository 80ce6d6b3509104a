"""The benchmark of the PyTorch and CUDA port (``adaptive_mcmc_tpu_torch``).

One run measures one cell of ``BENCHMARK.json`` on one machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, job kind,
per-layer metric or kernel count lives in a file of its own, found by the
name that ``BENCHMARK.json`` gives it (``registry.py``).  Nothing here
imports JAX or the JAX package ``adaptive_mcmc_tpu``; ``reference/`` imports
nothing of the port either.
"""
