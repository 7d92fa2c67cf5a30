"""The experiment drivers (the port of ``online_gp_tpu/experiments``):
the Hydra-style config, the regression, classification and fixed-noise
drivers and the sequential sweep."""
