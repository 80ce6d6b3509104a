from adaptive_mcmc_tpu_torch.kernels.base import Kernel  # noqa: F401
from adaptive_mcmc_tpu_torch.kernels.arwmh import (  # noqa: F401
    ARWMHAdaptState,
    ARWMHConfig,
    ARWMHState,
    arwmh,
    rwm,
)
from adaptive_mcmc_tpu_torch.kernels.asss import (  # noqa: F401
    ASSSAdaptState,
    ASSSConfig,
    ASSSDraws,
    ASSSState,
    asss,
)
from adaptive_mcmc_tpu_torch.kernels.sa import (  # noqa: F401
    SAAdaptState,
    SAConfig,
    SADraws,
    SAState,
    sa,
)

from adaptive_mcmc_tpu_torch.infer.mcmc import register_kernel_factory

register_kernel_factory("arwmh", arwmh)
register_kernel_factory("asss", asss)
register_kernel_factory("sa", sa)
