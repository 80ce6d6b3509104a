from adaptive_mcmc_tpu_torch.models.base import (  # noqa: F401
    SiteSpec,
    Target,
    folded_student_t_logpdf,
    half_cauchy_logpdf,
    normal_logpdf,
    student_t_logpdf,
    sum_in_order,
    sum_strided,
)
from adaptive_mcmc_tpu_torch.models.targets import (  # noqa: F401
    diamonds,
    eight_schools_centered,
    eight_schools_noncentered,
    gaussian_mixture_1d,
    kidiq,
    mvn,
    std_normal,
)
from adaptive_mcmc_tpu_torch.models import data  # noqa: F401
