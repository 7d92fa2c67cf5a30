"""Functional model cores of the port: WISKI (``wiski``, ``wiski_lowrank``,
``partial_mll``) and the online baselines' cores, exported here."""

from online_gp_torch.models.exact import exact_mll, exact_posterior, ski_kernel_matrix
from online_gp_torch.models.exact_online import (
    ExactGPData,
    ExactGPModel,
    exact_data_append,
    exact_data_init,
    exact_gp_mll,
    exact_gp_observation_variance,
    exact_gp_posterior,
)
from online_gp_torch.models.localgp import (
    LocalGPModel,
    LocalGPState,
    localgp_add_point,
    localgp_init,
    localgp_joint_mll,
    localgp_log_prob,
    localgp_predict,
    localgp_route,
    localgp_weights,
)
from online_gp_torch.models.sgpr import (
    SGPRModel,
    SGPRMoments,
    SGPROldState,
    sgpr_absorb,
    sgpr_bound,
    sgpr_c_matrix,
    sgpr_c_vec,
    sgpr_moments,
    sgpr_moments_from,
    sgpr_predict,
    sgpr_pseudotargets,
    sgpr_resample_z,
)
from online_gp_torch.models.svgp import (
    SVGPModel,
    SVGPOldState,
    gaussian_expected_log_prob,
    svgp_closed_form_update,
    svgp_elbo,
    svgp_exact_estep,
    svgp_init_variational_to_prior,
    svgp_kl_to_prior,
    svgp_predict,
    svgp_snapshot,
    svgp_streaming_correction,
)

__all__ = [
    "ExactGPData", "ExactGPModel", "exact_data_append", "exact_data_init", "exact_gp_mll",
    "exact_gp_observation_variance", "exact_gp_posterior", "exact_mll", "exact_posterior", "ski_kernel_matrix",
    "LocalGPModel", "LocalGPState", "localgp_add_point", "localgp_init", "localgp_joint_mll", "localgp_log_prob",
    "localgp_predict", "localgp_route", "localgp_weights",
    "SGPRModel", "SGPRMoments", "SGPROldState", "sgpr_absorb", "sgpr_bound", "sgpr_c_matrix", "sgpr_c_vec",
    "sgpr_moments", "sgpr_moments_from", "sgpr_predict", "sgpr_pseudotargets", "sgpr_resample_z",
    "SVGPModel", "SVGPOldState", "gaussian_expected_log_prob", "svgp_closed_form_update", "svgp_elbo",
    "svgp_exact_estep", "svgp_init_variational_to_prior", "svgp_kl_to_prior", "svgp_predict", "svgp_snapshot",
    "svgp_streaming_correction",
]
