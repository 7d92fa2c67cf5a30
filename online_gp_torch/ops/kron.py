"""Kronecker products for grid kernels (port of ``online_gp_tpu/ops/kron.py``).

A stationary product kernel on a Cartesian grid factors as
K_uu = T_0 ⊗ T_1 ⊗ ... ⊗ T_{D-1}, row-major (dimension 0 slowest), the
order :class:`online_gp_torch.ops.grid.Grid` flattens in. The MVM
contracts each factor along its own axis: D small matmuls instead of one
m x m product.
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


def kron_mvm(factors: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(⊗_d T_d) @ x for x of shape (..., m, k), m = prod of factor sizes;
    the factors' leading dims broadcast against x's."""
    sizes = [f.shape[-1] for f in factors]
    batch = x.shape[:-2]
    k = x.shape[-1]
    t = x.reshape(*batch, *sizes, k)
    nb = len(batch)
    for d, f in enumerate(factors):
        # move axis d (offset by the batch) to last-but-one and contract
        t = torch.movedim(t, nb + d, -2)
        fb = f.reshape(*f.shape[:-2], *([1] * (len(sizes) - 1)), *f.shape[-2:])
        dtype = torch.promote_types(fb.dtype, t.dtype)  # jnp.matmul's promotion
        t = torch.matmul(fb.to(dtype), t.to(dtype))
        t = torch.movedim(t, -2, nb + d)
    return t.reshape(*batch, -1, k)
