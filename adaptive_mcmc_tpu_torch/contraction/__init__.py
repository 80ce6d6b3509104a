"""Lipschitz-NN contraction estimators (PyTorch), with the names of
``adaptive_mcmc_tpu.contraction``; ``MLPParams`` is the module
``LipschitzMLP`` here."""

from adaptive_mcmc_tpu_torch.contraction.lipschitz import (  # noqa: F401
    LipschitzMLP,
    apply_lipschitz_mlp,
    compute_kernel_distance,
    compute_kernel_distance_1d,
    compute_wasserstein_contraction,
    init_lipschitz_mlp,
    make_sample_px,
    spectral_norm,
)

MLPParams = LipschitzMLP
