"""Bayesian optimization and active learning on the port (port of
``online_gp_tpu/bayesopt``): test functions, the MC acquisitions,
``optimize_acqf``, and the drivers ``loop.run_bayesopt``,
``active_learning.run_active_learning`` and ``mpv_osvgp.run_mpv_osvgp``."""

from online_gp_torch.bayesopt.acquisitions import (
    q_expected_improvement,
    q_knowledge_gradient,
    q_max_value_entropy,
    q_negative_integrated_posterior_variance,
    q_noisy_expected_improvement,
    q_upper_confidence_bound,
)
from online_gp_torch.bayesopt.optimize import optimize_acqf
from online_gp_torch.bayesopt.test_functions import TEST_FUNCTIONS, make_test_function

__all__ = [
    "make_test_function",
    "TEST_FUNCTIONS",
    "q_expected_improvement",
    "q_upper_confidence_bound",
    "q_noisy_expected_improvement",
    "q_knowledge_gradient",
    "q_max_value_entropy",
    "q_negative_integrated_posterior_variance",
    "optimize_acqf",
]
