"""Invariance and contraction-curve checks (PyTorch), with the names of
``adaptive_mcmc_tpu.analysis`` for what the port has."""

from adaptive_mcmc_tpu_torch.analysis.invariance import (  # noqa: F401
    invariance_ks,
    ks_null_threshold,
    ks_statistic,
    push_through_kernel,
)
from adaptive_mcmc_tpu_torch.analysis.contraction_curves import (  # noqa: F401
    contraction_decay_curve,
    frozen_arwmh,
    frozen_asss,
    taus_finite_difference,
    taus_finite_difference_arctan,
)
