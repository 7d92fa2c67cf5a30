"""Kronecker products for grid kernels (port of ``online_gp_tpu/ops/kron.py``).

A stationary product kernel on a Cartesian grid factors as
K_uu = T_0 ⊗ T_1 ⊗ ... ⊗ T_{D-1}, row-major (dimension 0 slowest), the
order :class:`online_gp_torch.ops.grid.Grid` flattens in.
"""

from __future__ import annotations

from typing import Sequence

import torch


def kron_dense(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Dense T_0 ⊗ ... ⊗ T_{D-1}; leading batch dims broadcast."""
    out = factors[0]
    for f in factors[1:]:
        b = torch.broadcast_shapes(out.shape[:-2], f.shape[:-2])
        m1, n1 = out.shape[-2:]
        m2, n2 = f.shape[-2:]
        prod = out[..., :, None, :, None] * f[..., None, :, None, :]
        out = prod.reshape(*b, m1 * m2, n1 * n2)
    return out
