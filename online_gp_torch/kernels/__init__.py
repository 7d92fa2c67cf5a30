"""Kernel functions, priors and inducing-grid K_uu assembly."""

from online_gp_torch.kernels.base import (
    ExpTransform,
    IntervalTransform,
    Kernel,
    MaternKernel,
    RadialMaternKernel,
    RBFKernel,
    make_kernel,
)
from online_gp_torch.kernels.priors import GammaPrior, NormalPrior, log_prior_sum
from online_gp_torch.kernels.spectral_mixture import SpectralMixtureKernel, sm_init_from_data

__all__ = [
    "ExpTransform",
    "GammaPrior",
    "IntervalTransform",
    "Kernel",
    "MaternKernel",
    "NormalPrior",
    "RadialMaternKernel",
    "RBFKernel",
    "SpectralMixtureKernel",
    "log_prior_sum",
    "make_kernel",
    "sm_init_from_data",
]
