"""The experiment harness (PyTorch): w_eval and lr_decay sweeps, their
evaluation against gold-standard draws, and the CLI, with the names of
``adaptive_mcmc_tpu.experiments``."""

from adaptive_mcmc_tpu_torch.experiments.configs import (  # noqa: F401
    LR_DECAYS,
    W_EVAL_BUDGETS,
    RunConfig,
    w_eval_config,
)
from adaptive_mcmc_tpu_torch.experiments.runner import (  # noqa: F401
    TARGETS,
    build_kernel,
    run_lr_decay,
    run_w_eval,
)
from adaptive_mcmc_tpu_torch.experiments.evaluate import (  # noqa: F401
    evaluate_run,
    get_reference_draws,
    make_reference_draws,
)
