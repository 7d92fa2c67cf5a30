"""Static solver configuration (PyTorch port).

The port's own copy of ``online_gp_tpu/config.py``: the same fields with
the same defaults, so a config built for one package reads the same in
the other. PyTorch runs eagerly, so these are plain run-time switches
rather than compile-time branches.

Every switch is live: above ``max_cholesky_size`` the MLL runs CG/SLQ
(``cg_tolerance``, ``max_cg_iterations``, ``use_toeplitz``), and
``fast_pred_var`` / ``fast_pred_samples`` below full rank run Lanczos at
``max_root_decomposition_size``. ``grid_shard_axis`` names a mesh axis in
the JAX package; the port has no sharded path, so only ``None`` is
accepted.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Numerics switches for the structured GP solvers.

    - ``max_cholesky_size``: dense Cholesky for systems up to this size.
    - ``max_root_decomposition_size``: Lanczos rank cap for root
      decompositions.
    - ``cg_tolerance`` / ``max_cg_iterations``: batched-CG controls.
    - ``cholesky_jitter`` / ``max_cholesky_jitter_tries``: diagonal jitter
      added before a Cholesky, escalated 10x per failed try.
    - ``fast_pred_var``: LOVE-style low-rank predictive covariance.
    - ``fast_pred_samples``: root-decomposed predictive covariance.
    - ``skip_posterior_variances``: prediction returns the mean only.
    - ``skip_logdet_forward``: drop log|Q| from the MLL's forward value.
    - ``detach_interp_coeff``: stop gradients through the SKI weights.
    - ``use_toeplitz``: Toeplitz (FFT) grid-kernel MVMs.
    - ``grid_shard_axis``: must be ``None`` in the port.
    """

    max_cholesky_size: int = 2048
    max_root_decomposition_size: int = 512
    cg_tolerance: float = 1e-2
    max_cg_iterations: int = 256
    cholesky_jitter: float = 1e-6
    max_cholesky_jitter_tries: int = 5
    fast_pred_var: bool = False
    fast_pred_samples: bool = False
    skip_posterior_variances: bool = False
    skip_logdet_forward: bool = False
    detach_interp_coeff: bool = False
    use_toeplitz: bool = False
    grid_shard_axis: "str | None" = None

    def __post_init__(self):
        if self.grid_shard_axis is not None:
            raise ValueError(
                "online_gp_torch has no sharded grid path: grid_shard_axis "
                f"must be None (got {self.grid_shard_axis!r})"
            )

    def replace(self, **kwargs) -> "SolverConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = SolverConfig()
