"""Likelihood helpers."""

from online_gp_torch.likelihoods.bernoulli import bernoulli_probit_expected_log_prob, bernoulli_probit_predictive
from online_gp_torch.likelihoods.dirichlet import dirichlet_transform
from online_gp_torch.likelihoods.gaussian import fnmg_noise, gaussian_nll

__all__ = [
    "bernoulli_probit_expected_log_prob",
    "bernoulli_probit_predictive",
    "dirichlet_transform",
    "fnmg_noise",
    "gaussian_nll",
]
