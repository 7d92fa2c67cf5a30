"""Symmetric-Toeplitz products by FFT circulant embedding (port of
``online_gp_tpu/ops/toeplitz.py``).

On a uniform 1-D grid a stationary kernel's Gram matrix is symmetric
Toeplitz. It is embedded in a 2m circulant and applied with two real FFTs,
O(m log m) per column. The JAX package computes these FFTs outside any
Pallas kernel; here they are ``torch.fft`` calls.
"""

from __future__ import annotations

from typing import Callable

import torch


def toeplitz_operator(col: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> T @ x for the symmetric Toeplitz T with first column ``col``
    (..., m), with the column's FFT taken once: an iterative solver applies
    the operator many times (XLA hoists the same FFT out of the JAX
    package's loops). The column's leading dims broadcast against x's; the
    FFT runs in the column's own dtype, as in the JAX package."""
    m = col.shape[-1]
    # circulant embedding: [c_0, c_1, .., c_{m-1}, 0, c_{m-1}, .., c_1]
    emb = torch.cat([col, torch.zeros_like(col[..., :1]), torch.flip(col[..., 1:], dims=(-1,))], dim=-1)
    f_emb = torch.fft.rfft(emb, dim=-1)[..., :, None]  # (..., m+1, 1)

    def apply(x: torch.Tensor) -> torch.Tensor:
        f_x = torch.fft.rfft(x, n=2 * m, dim=-2)  # x zero-padded to 2m: (..., m+1, k)
        return torch.fft.irfft(f_emb * f_x, n=2 * m, dim=-2)[..., :m, :].to(x.dtype)

    return apply


def toeplitz_mvm(col: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Symmetric-Toeplitz MVM.

    Args:
      col: (..., m) first column of the symmetric Toeplitz matrix.
      x: (..., m, k) right-hand sides.

    Returns (..., m, k) = T @ x in x's dtype.
    """
    return toeplitz_operator(col)(x)


def sym_toeplitz_dense(col: torch.Tensor) -> torch.Tensor:
    """The symmetric Toeplitz matrix (..., m, m) from its first column."""
    m = col.shape[-1]
    i = torch.arange(m, device=col.device)
    return col[..., torch.abs(i[:, None] - i[None, :])]
