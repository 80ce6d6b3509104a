"""adaptive_mcmc_tpu_torch — the PyTorch/CUDA port of adaptive_mcmc_tpu.

The JAX package ``adaptive_mcmc_tpu`` is the reference; this package runs
the same samplers in PyTorch on an NVIDIA H100, with every TPU kernel of the
path rewritten by hand in CUDA C++ for ``sm_90a`` (``csrc/``).  It holds the
samplers so far: batched adaptive ARWMH, ASSS, SA and NUTS on the PosteriorDB
posteriors (eight schools noncentered and centered, kidiq, diamonds),
driven by ``run_mcmc`` / ``MCMC`` (and the resumable
``run_mcmc_checkpointed`` and the log-grid ``collect_states_logscale``),
and the diagnostics: ``metrics`` (moments, sliced and exact Wasserstein
with the ε-auction, MMD, Sinkhorn), ``sample_pnx``, ``contraction`` (the
Lipschitz-NN estimators) and ``analysis`` (invariance and contraction
curves), with kernel K1 (the rank-1 Cholesky
update), kernel K2 (the fused ARWMH sweep, ``ARWMHConfig(fused=True)``) and kernel
K3 (the fused ASSS sweep, ``ASSSConfig(fused=True)``), both taking every
posterior above, diamonds at d = 26 included.  It
never imports JAX.

    import torch
    import adaptive_mcmc_tpu_torch as amt

    target = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.arwmh(target), num_warmup=5000, num_samples=20000,
                    thinning=10, n_chains=4096)
    mcmc.run(torch.Generator("cuda").manual_seed(0))
    mcmc.print_summary()

    asss = amt.asss(target, amt.ASSSConfig(fused=True))   # through K3
"""

import torch

from adaptive_mcmc_tpu_torch import kernels  # noqa: F401  (registers)
from adaptive_mcmc_tpu_torch.models import (  # noqa: F401
    Target,
    diamonds,
    eight_schools_centered,
    eight_schools_noncentered,
    gaussian_mixture_1d,
    kidiq,
    mvn,
    std_normal,
)
from adaptive_mcmc_tpu_torch.kernels import (  # noqa: F401
    ARWMHAdaptState,
    ARWMHConfig,
    ARWMHState,
    ASSSAdaptState,
    ASSSConfig,
    ASSSDraws,
    ASSSState,
    NUTSAdaptState,
    NUTSConfig,
    NUTSDraws,
    NUTSState,
    SAAdaptState,
    SAConfig,
    SADraws,
    SAState,
    arwmh,
    asss,
    nuts,
    rwm,
    sa,
)
from adaptive_mcmc_tpu_torch.infer import (  # noqa: F401
    MCMC,
    ChainHealthError,
    check_chain_health,
    collect_states_logscale,
    get_init_adapt_state,
    ns_logscale,
    run_mcmc,
    run_mcmc_checkpointed,
    sample_pnx,
)
from adaptive_mcmc_tpu_torch import (  # noqa: F401
    analysis,
    contraction,
    metrics,
)

__version__ = "0.1.0"

# float32 products in full precision on the card (the JAX side pins
# Precision.HIGHEST for the proposal matvec).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
