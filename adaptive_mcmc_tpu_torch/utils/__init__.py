from adaptive_mcmc_tpu_torch.utils.checkpoint import (  # noqa: F401
    SweepManifest,
    load_state,
    save_state,
)
from adaptive_mcmc_tpu_torch.utils.profiling import (  # noqa: F401
    PhaseTimer,
    format_rate,
    trace,
)
