"""Kernel functions and inducing-grid K_uu assembly."""

from online_gp_torch.kernels.base import ExpTransform, IntervalTransform, Kernel, RBFKernel

__all__ = ["ExpTransform", "IntervalTransform", "Kernel", "RBFKernel"]
