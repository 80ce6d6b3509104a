"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with a
wrapper that launches it for CUDA tensors, a plain PyTorch version that the
wrapper runs for CPU tensors, and a launch counter:

* ``chol_update`` — K1, the batched rank-1 Cholesky update;
* ``arwmh_fused`` — K2, the fused ARWMH sweep.
"""
