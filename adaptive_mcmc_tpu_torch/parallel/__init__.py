"""Chain-parallel execution (PyTorch): the one-device part of
``adaptive_mcmc_tpu.parallel``, its collectives included.
``chain_sharding`` and ``replicated`` wait for torch.distributed (ROADMAP
A15)."""

from adaptive_mcmc_tpu_torch.parallel.mesh import (  # noqa: F401
    CHAIN_AXIS,
    chain_mesh,
    initialize_distributed,
)
from adaptive_mcmc_tpu_torch.parallel.run import (  # noqa: F401
    cross_chain_moments,
    fan_state,
    run_mcmc_sharded,
    sharded_gelman_rubin,
)
