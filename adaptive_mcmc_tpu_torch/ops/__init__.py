"""Hot sequential math: the rank-1 Cholesky update (``cholesky``) and the
CUDA kernels with their wrappers and plain versions (``cuda``)."""
