"""Dense exact GP: the baseline's math and the parity oracle (port of
``online_gp_tpu/models/exact.py``).

``ski_kernel_matrix`` evaluates the SKI-approximated kernel
W_x1 K_uu W_x2^T, so that the oracle has WISKI's model class exactly;
``exact_mll`` and ``exact_posterior`` are the dense zero-mean GP's MLL
(normalized by n) and posterior f-moments.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from online_gp_torch.kernels.base import Kernel
from online_gp_torch.kernels.grid_kernel import grid_kuu_dense
from online_gp_torch.ops.chol import cho_solve, chol_logdet, cholesky, sym_psd_safe_cholesky, tri_solve
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import dense_w, interp_coeffs
from online_gp_torch.ops.precision import f32_matmuls

LOG_2PI = 1.8378770664093453


def ski_kernel_matrix(
    kernel: Kernel,
    params: Dict,
    grid: Grid,
    x1: torch.Tensor,
    x2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """W_x1 K_uu W_x2^T: the effective WISKI prior covariance (..., n1, n2)."""
    m = grid.num_points
    Kuu = grid_kuu_dense(kernel, params, grid)
    i1, w1 = interp_coeffs(grid, x1)
    W1 = dense_w(i1, w1, m).T
    if x2 is None:
        W2 = W1
    else:
        i2, w2 = interp_coeffs(grid, x2)
        W2 = dense_w(i2, w2, m).T
    return W1 @ Kuu @ W2.mT


def _with_noise(K: torch.Tensor, noise_diag: torch.Tensor) -> torch.Tensor:
    n = K.shape[-1]
    return K + noise_diag[..., :, None] * torch.eye(n, dtype=K.dtype, device=K.device)


@f32_matmuls
def exact_mll(K: torch.Tensor, y: torch.Tensor, noise_diag: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Dense GP MLL (zero mean) / n for K (..., n, n), y (..., n) and
    noise_diag (..., n); (...,). No jitter escalation: NaN where K + noise
    does not factor."""
    n = K.shape[-1]
    Khat = _with_noise(K, noise_diag)
    if jitter:
        Khat = Khat + jitter * torch.eye(n, dtype=K.dtype, device=K.device)
    L = cholesky(0.5 * (Khat + Khat.mT))
    alpha = tri_solve(L, y[..., None])
    quad = torch.sum(alpha * alpha, dim=(-2, -1))
    return -0.5 * (quad + chol_logdet(L) + n * LOG_2PI) / n


@f32_matmuls
def exact_posterior(
    K_train: torch.Tensor,
    K_cross: torch.Tensor,
    K_test_diag: torch.Tensor,
    y: torch.Tensor,
    noise_diag: torch.Tensor,
    jitter: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense posterior f-moments for K_train (..., n, n), K_cross (..., t, n),
    K_test_diag (..., t), y (..., n), noise_diag (..., n): mean and variance
    (..., t)."""
    L = sym_psd_safe_cholesky(_with_noise(K_train, noise_diag), jitter=jitter)
    alpha = cho_solve(L, y[..., None])
    mean = (K_cross @ alpha)[..., 0]
    v = tri_solve(L, K_cross.mT)
    var = K_test_diag - torch.sum(v * v, dim=-2)
    return mean, torch.clamp(var, min=1e-12)
