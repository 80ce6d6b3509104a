"""Chain-parallel execution (PyTorch): ``adaptive_mcmc_tpu.parallel``'s
functions over ``torch.distributed``, one process per device: the chain
mesh and its shardings, the sharded driver and the collectives."""

from adaptive_mcmc_tpu_torch.parallel.mesh import (  # noqa: F401
    CHAIN_AXIS,
    ChainMesh,
    chain_mesh,
    chain_sharding,
    initialize_distributed,
    rank_generator,
    rank_seed,
    replicated,
)
from adaptive_mcmc_tpu_torch.parallel.run import (  # noqa: F401
    cross_chain_moments,
    fan_state,
    gather_chains,
    run_mcmc_sharded,
    sharded_gelman_rubin,
)
