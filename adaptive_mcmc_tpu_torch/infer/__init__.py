from adaptive_mcmc_tpu_torch.infer.mcmc import (  # noqa: F401
    MCMC,
    get_init_adapt_state,
    register_kernel_factory,
    run_mcmc,
    sample_pnx,
)
from adaptive_mcmc_tpu_torch.infer.collect import (  # noqa: F401
    collect_states_logscale,
    concat_trees,
    ns_logscale,
)
from adaptive_mcmc_tpu_torch.infer.checkpointed import (  # noqa: F401
    ChainHealthError,
    check_chain_health,
    run_mcmc_checkpointed,
)
from adaptive_mcmc_tpu_torch.infer.diagnostics import (  # noqa: F401
    effective_sample_size,
    gelman_rubin,
    summarize,
    summary_table,
)
