"""SKI cubic-convolution interpolation (port of ``online_gp_tpu/ops/interp.py``).

Keys cubic convolution (a = -1/2): a 4-point stencil per input dimension,
so a D-dimensional query touches P = 4^D grid points. W is never stored
as a sparse format: each query is a (P,) row of flat grid indices and
weights, and W's action is a gather and weighted sum
(:func:`interp_matvec`), a scatter-add into dense grid vectors
(:func:`dense_w`, :func:`wt_matvec`), or the fused posterior gather
(:func:`gather_predict`).

Indices are int64 (what torch indexing takes). Duplicate indices, which
the edge clamp can produce, are summed, as ``index_add_`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from online_gp_torch.ops.grid import Grid


def _keys_cubic(u: torch.Tensor) -> torch.Tensor:
    """Keys cubic-convolution kernel with a = -1/2 (Catmull-Rom).

    W(u) = 1.5|u|^3 - 2.5|u|^2 + 1          for |u| <= 1
         = -0.5|u|^3 + 2.5|u|^2 - 4|u| + 2  for 1 < |u| <= 2
         = 0                                 otherwise
    """
    a = torch.abs(u)
    near = ((1.5 * a - 2.5) * a) * a + 1.0
    far = ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0
    return torch.where(a <= 1.0, near, torch.where(a <= 2.0, far, torch.zeros_like(a)))


def interp_coeffs(
    grid: Grid, x: torch.Tensor, detach: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cubic interpolation indices/weights for query points.

    Args:
      grid: the inducing grid (on the same device as ``x``).
      x: (n, D) query points.
      detach: stop gradients through the weights.

    Returns:
      idx: (n, P) int64 flat grid indices, P = 4^D.
      w:   (n, P) interpolation weights (rows sum to 1 inside the bounds).
    """
    n = x.shape[0]
    dev = x.device
    flat_idx = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    flat_w = torch.ones((n, 1), dtype=x.dtype, device=dev)
    offsets = torch.arange(4, dtype=torch.int64, device=dev)
    rel = torch.arange(-1, 3, dtype=x.dtype, device=dev)  # made on the device: no host copy, no sync

    for d in range(grid.ndim):
        m = grid.sizes[d]
        u = (x[:, d] - grid.mins[d]) / grid.spacings[d]  # grid coords
        # clamp so the 4-point stencil {i-1, i, i+1, i+2} stays in range
        i = torch.floor(u).to(torch.int64).clamp(1, m - 3)
        t = u - i.to(u.dtype)  # signed offset from the left-center node
        wd = _keys_cubic(t[:, None] - rel[None, :])  # (n, 4)
        idx_d = (i[:, None] - 1) + offsets[None, :]  # (n, 4)
        flat_idx = (flat_idx[:, :, None] + idx_d[:, None, :] * grid.strides[d]).reshape(n, -1)
        flat_w = (flat_w[:, :, None] * wd[:, None, :]).reshape(n, -1)

    if detach:
        flat_w = flat_w.detach()
    return flat_idx, flat_w


def interp_matvec(idx: torch.Tensor, w: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """W_x @ cache: (n, P) stencil against a (..., m, k) grid matrix,
    returns (..., n, k)."""
    gathered = cache[..., idx, :]  # (..., n, P, k)
    return torch.einsum("np,...npk->...nk", w, gathered)


def interp_root_matvec(idx: torch.Tensor, w: torch.Tensor, root_cache: torch.Tensor) -> torch.Tensor:
    """W_x @ R for a covariance root R (the ``fast_pred_samples`` path):
    (n, P) stencil against a (..., m, k) root, returns (..., n, k)."""
    return interp_matvec(idx, w, root_cache)


def _densify_rows(idx: torch.Tensor, w: torch.Tensor, num_grid: int) -> torch.Tensor:
    """(n, P) stencil -> dense (n, m) rows; duplicate indices are summed."""
    rows = torch.zeros((idx.shape[0], num_grid), dtype=w.dtype, device=w.device)
    return rows.scatter_add(1, idx, w)


def dense_w(idx: torch.Tensor, w: torch.Tensor, num_grid: int) -> torch.Tensor:
    """Densify W^T for a batch of points: returns (m, n) columns,
    duplicate stencil indices summed (scatter-add)."""
    n, P = idx.shape
    cols = torch.zeros((num_grid, n), dtype=w.dtype, device=w.device)
    point_ids = torch.arange(n, device=idx.device)[:, None].expand(n, P)
    return cols.index_put((idx.reshape(-1), point_ids.reshape(-1)), w.reshape(-1), accumulate=True)


def wt_matvec(idx: torch.Tensor, w: torch.Tensor, v: torch.Tensor, num_grid: int) -> torch.Tensor:
    """W^T applied to point-space vectors: (n, k) -> (m, k), in v's dtype
    (the products are cast to it before the sum, as the JAX package's
    scatter-add casts its updates)."""
    n, P = idx.shape
    contrib = (w[:, :, None] * v[:, None, :]).to(v.dtype)  # (n, P, k)
    out = torch.zeros((num_grid, v.shape[-1]), dtype=v.dtype, device=v.device)
    return out.index_add(0, idx.reshape(-1), contrib.reshape(n * P, v.shape[-1]))


def gather_predict(
    idx: torch.Tensor,
    w: torch.Tensor,
    mean_cache: torch.Tensor,
    cov_cache: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused posterior gather: mean = W_x mu, var = diag(W_x C W_x^T).

    Args:
      idx, w: (n, P) interpolation coefficients.
      mean_cache: (..., m, 1); cov_cache: (..., m, m) or None.

    Returns mean (..., n) and var (..., n) or None. The variance gathers
    the (n, P, P) submatrices C[idx_i, idx_j] and never forms the dense
    (n, m) W block.
    """
    mean = interp_matvec(idx, w, mean_cache)[..., 0]
    if cov_cache is None:
        return mean, None
    sub = cov_cache[..., idx[:, :, None], idx[:, None, :]]  # (..., n, P, P)
    var = torch.einsum("np,...npq,nq->...n", w, sub, w)
    return mean, var
