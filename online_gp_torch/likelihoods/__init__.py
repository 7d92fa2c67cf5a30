"""Likelihood helpers."""

from online_gp_torch.likelihoods.gaussian import fnmg_noise, gaussian_nll

__all__ = ["fnmg_noise", "gaussian_nll"]
