"""Sample-quality metrics (PyTorch): moments, sliced and exact
Wasserstein, MMD and Sinkhorn, with the same names as
``adaptive_mcmc_tpu.metrics``."""

from adaptive_mcmc_tpu_torch.metrics.moments import pth_moment_rmse  # noqa: F401
from adaptive_mcmc_tpu_torch.metrics.sliced import (  # noqa: F401
    max_sliced_wasserstein,
    sliced_wasserstein,
    wasserstein_1d,
)
from adaptive_mcmc_tpu_torch.metrics.mmd import (  # noqa: F401
    gaussian_kernel,
    median_sq_dist,
    mmd2_unbiased,
    mmd_heuristic,
    mmd_heuristic_many,
)
from adaptive_mcmc_tpu_torch.metrics.sinkhorn import (  # noqa: F401
    wasserstein_sinkhorn,
    wasserstein_sinkhorn_unbiased,
)
from adaptive_mcmc_tpu_torch.metrics.wasserstein import (  # noqa: F401
    minkowski_cost_matrix,
    wasserstein_dist11_p,
)
from adaptive_mcmc_tpu_torch.metrics.assignment import (  # noqa: F401
    auction_assignment,
    linear_sum_assignment,
)
