"""online_gp_torch: the PyTorch/CUDA port of online_gp_tpu.

Streaming Gaussian processes (WISKI) in PyTorch, with the Pallas TPU
kernels of the JAX package rewritten as CUDA C++ kernels for NVIDIA
Hopper (``online_gp_torch/csrc``). The JAX package ``online_gp_tpu`` is
the reference; this package imports nothing of it and nothing of JAX.

Entry points run on the device of the tensors they are given: CUDA for
real work, the CPU (plain PyTorch versions of every kernel) for tests.
"""

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig

__all__ = ["DEFAULT_CONFIG", "SolverConfig"]
