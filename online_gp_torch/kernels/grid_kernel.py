"""Inducing-grid kernel assembly (port of
``online_gp_tpu/kernels/grid_kernel.py``).

- ``grid_kuu_factors``: the per-dimension (..., m_d, m_d) dense factors,
  with the output scale (a mixture component's weight) folded into
  dimension 0.
- ``grid_kuu_dense``: the dense (..., m, m) K_uu from their Kronecker
  product, summed over the components of a mixture kernel.
- ``grid_kuu_operator`` / ``grid_kuu_mvm``: K_uu @ x without K_uu: a
  Kronecker chain of dense factors, or of Toeplitz-FFT products under
  ``use_toeplitz``; the operator builds the factors (or the columns' FFTs)
  once for many products.

Where the JAX package vmaps one output's params over an output batch,
these take the batched params and broadcast them against x's leading
dims.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from online_gp_torch.kernels.base import Kernel, Params
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.kron import kron_dense, kron_mvm
from online_gp_torch.ops.toeplitz import toeplitz_operator


def _num_components(kernel: Kernel) -> int:
    """Mixture kernels (the spectral mixture) are sums of separable
    components; K_uu is then a sum of Kronecker chains."""
    return int(getattr(kernel, "num_components", 1))


def grid_kuu_factors(kernel: Kernel, params: Params, grid: Grid, component: Optional[int] = None) -> List[torch.Tensor]:
    """Per-dimension dense grid factors; output scale (or the component's
    weight) folded into dim 0. ``component`` selects a mixture component."""
    if component is None:
        return [kernel.factor_1d(params, d, grid.points_1d(d), include_scale=(d == 0)) for d in range(grid.ndim)]
    return [
        kernel.component_factor_1d(params, component, d, grid.points_1d(d), include_weight=(d == 0))
        for d in range(grid.ndim)
    ]


def grid_kuu_dense(kernel: Kernel, params: Params, grid: Grid) -> torch.Tensor:
    """Dense (..., m, m) inducing kernel matrix."""
    nc = _num_components(kernel)
    if nc == 1:
        return kron_dense(grid_kuu_factors(kernel, params, grid))
    out = kron_dense(grid_kuu_factors(kernel, params, grid, component=0))
    for q in range(1, nc):
        out = out + kron_dense(grid_kuu_factors(kernel, params, grid, component=q))
    return out


def grid_kuu_operator(
    kernel: Kernel, params: Params, grid: Grid, use_toeplitz: bool = True
) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> K_uu @ x without materializing K_uu, with every per-dimension
    factor (or its column's FFT) built once, for solvers that apply K_uu
    many times.

    x is (..., m, k); the params' leading (batch) dims are x's leading dims
    or absent.
    """
    nc = _num_components(kernel)
    ops = [_component_operator(kernel, params, grid, use_toeplitz, q) for q in ([None] if nc == 1 else range(nc))]

    def apply(x: torch.Tensor) -> torch.Tensor:
        out = ops[0](x)
        for op in ops[1:]:
            out = out + op(x)
        return out

    return apply


def grid_kuu_mvm(kernel: Kernel, params: Params, grid: Grid, x: torch.Tensor, use_toeplitz: bool = True) -> torch.Tensor:
    """K_uu @ x without materializing K_uu (:func:`grid_kuu_operator` once).

    Args:
      x: (..., m, k) grid-space right-hand sides; the params' leading
        (batch) dims are x's leading dims or absent.
    """
    return grid_kuu_operator(kernel, params, grid, use_toeplitz)(x)


def _component_operator(kernel, params, grid, use_toeplitz, q):
    """One separable component's K_uu product: a Kronecker chain of dense
    factors, or of Toeplitz-FFT products along each dimension."""
    if not use_toeplitz:
        factors = grid_kuu_factors(kernel, params, grid, component=q)
        return lambda x: kron_mvm(factors, x)
    D = grid.ndim
    dim_ops = []
    for d in range(D):
        g = grid.points_1d(d)
        if q is None:
            col = kernel.factor_col(params, d, g, include_scale=(d == 0))
        else:
            col = kernel.component_factor_col(params, q, d, g, include_weight=(d == 0))
        dim_ops.append(toeplitz_operator(col.reshape(*col.shape[:-1], *([1] * (D - 1)), col.shape[-1])))

    def apply(x):
        batch, k = x.shape[:-2], x.shape[-1]
        nb = len(batch)
        t = x.reshape(*batch, *grid.sizes, k)
        for d, op in enumerate(dim_ops):
            t = torch.movedim(op(torch.movedim(t, nb + d, -2)), -2, nb + d)
        return t.reshape(*batch, -1, k)

    return apply
