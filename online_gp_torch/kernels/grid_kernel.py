"""Inducing-grid kernel assembly (port of
``online_gp_tpu/kernels/grid_kernel.py``, single-component kernels).

- ``grid_kuu_factors``: the per-dimension (..., m_d, m_d) dense factors,
  with the output scale folded into dimension 0.
- ``grid_kuu_dense``: the dense (..., m, m) K_uu from their Kronecker
  product.
"""

from __future__ import annotations

from typing import List

import torch

from online_gp_torch.kernels.base import Kernel, Params
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.kron import kron_dense


def grid_kuu_factors(kernel: Kernel, params: Params, grid: Grid) -> List[torch.Tensor]:
    """Per-dimension dense grid factors; output scale folded into dim 0."""
    return [
        kernel.factor_1d(params, d, grid.points_1d(d), include_scale=(d == 0))
        for d in range(grid.ndim)
    ]


def grid_kuu_dense(kernel: Kernel, params: Params, grid: Grid) -> torch.Tensor:
    """Dense (..., m, m) inducing kernel matrix."""
    return kron_dense(grid_kuu_factors(kernel, params, grid))
