"""PyTorch / CUDA port of the layered packed-GEMM system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX. Its kernels are hand-written CUDA C++ for ``sm_90a``
(``repro_torch/kernels/csrc``), built with ``nvcc`` at first use; on the CPU
every kernel wrapper runs its plain torch version instead.
"""
