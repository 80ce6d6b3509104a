from adaptive_mcmc_tpu_torch.infer.mcmc import (  # noqa: F401
    MCMC,
    get_init_adapt_state,
    register_kernel_factory,
    run_mcmc,
)
from adaptive_mcmc_tpu_torch.infer.diagnostics import (  # noqa: F401
    effective_sample_size,
    gelman_rubin,
    summarize,
    summary_table,
)
