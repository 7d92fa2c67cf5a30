"""Static solver configuration (PyTorch port).

The port's own copy of ``online_gp_tpu/config.py``: the same fields with
the same defaults, so a config built for one package reads the same in
the other. PyTorch runs eagerly, so these are plain run-time switches
rather than compile-time branches.

Every switch is live: above ``max_cholesky_size`` the MLL runs CG/SLQ
(``cg_tolerance``, ``max_cg_iterations``, ``use_toeplitz``), and
``fast_pred_var`` / ``fast_pred_samples`` below full rank run Lanczos at
``max_root_decomposition_size``. ``grid_shard_axis`` names the mesh axis
over which the inducing-grid dimension m is row-sharded
(:mod:`online_gp_torch.parallel.grid`).
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
    - ``grid_shard_axis``: the name of a mesh axis (a
      ``torch.distributed`` ``DeviceMesh`` dim) over which WISKI's grid
      dimension m is row-sharded, for grids past one device's memory.
      When set, ``wiski_mll``, ``wiski_prediction_caches``,
      ``wiski_predict``, ``wiski_grid_root`` and ``wiski_predict_root``
      take a state whose ``wty`` and roots are DTensors
      sharded on their m rows over that axis
      (:func:`online_gp_torch.parallel.grid.shard_wiski_state`) and run
      :mod:`online_gp_torch.parallel.grid`: each rank works on its rows
      with explicit ``all_reduce`` calls, Q = I + L^T K L and its factor
      replicated. ``None``: one device holds the whole state.
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

    def replace(self, **kwargs) -> "SolverConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = SolverConfig()
