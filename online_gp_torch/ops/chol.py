"""PSD-safe Cholesky with jitter escalation (port of
``online_gp_tpu/ops/chol.py``).

gpytorch's ``psd_safe_cholesky`` semantics: try a Cholesky and, where it
fails, retry with a 10x larger diagonal jitter, a fixed number of times.
As in the JAX package, gradient-free probes pick the first jitter level
that factors for each batch entry, then one differentiable factorization
runs at that level, so no gradient flows through a failed attempt. The
probes use ``torch.linalg.cholesky_ex`` and its ``info``: the plain
``cholesky`` raises where JAX returns NaN.

:func:`spd_cholesky` factors the matrices the math makes SPD with kernel
K6 on the card. Every factorization and solve runs with TF32 off
(:mod:`online_gp_torch.ops.precision`).
"""

from __future__ import annotations

import torch

from online_gp_torch.ops.cuda_chol import blocked_cholesky_ex
from online_gp_torch.ops.precision import f32_matmul_precision


def _factor_ok(mat: torch.Tensor) -> torch.Tensor:
    """(...,) bool: the Cholesky of ``mat`` exists and is finite."""
    chol, info = torch.linalg.cholesky_ex(mat)
    return (info == 0) & torch.isfinite(chol).all(dim=-1).all(dim=-1)


def psd_safe_cholesky(mat: torch.Tensor, jitter: float = 1e-6, tries: int = 3) -> torch.Tensor:
    """Lower Cholesky of a PSD matrix with escalating diagonal jitter.

    Args:
      mat: (..., n, n) symmetric PSD.
      jitter: initial jitter scale (times max(mean |diag|, 1); its gradient
        at a tie split in two, as JAX's).
      tries: number of 10x escalations.

    Returns the (..., n, n) lower factor at the first jitter level that
    factors; where none does, the last level is used and the result is
    NaN, as in the JAX package.
    """
    n = mat.shape[-1]
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    diag = torch.diagonal(mat, dim1=-2, dim2=-1)
    # torch.maximum, not clamp: at a tie (mean |diag| = 1, every unit-outputscale
    # Gram) it splits the gradient as jnp.maximum does; clamp passes it whole
    mean_diag = torch.mean(torch.abs(diag), dim=-1)
    diag_scale = torch.maximum(mean_diag, torch.ones_like(mean_diag))
    with f32_matmul_precision():
        probe_mat = mat.detach()
        chosen = torch.full(diag_scale.shape, float(tries - 1), dtype=mat.dtype, device=mat.device)
        done = torch.zeros(diag_scale.shape, dtype=torch.bool, device=mat.device)
        for level in range(tries):
            shift = (jitter * (10.0 ** level) * diag_scale.detach())[..., None, None] * eye
            ok = _factor_ok(probe_mat + shift)
            chosen = torch.where(ok & ~done, torch.full_like(chosen, float(level)), chosen)
            done = done | ok
            if bool(done.all()):
                break
        eps = jitter * (10.0 ** chosen) * diag_scale
        return cholesky(mat + eps[..., None, None] * eye)


def sym_psd_safe_cholesky(mat: torch.Tensor, jitter: float = 1e-6, tries: int = 3) -> torch.Tensor:
    """:func:`psd_safe_cholesky` of (mat + mat^T) / 2.

    ``jnp.linalg.cholesky`` symmetrizes its input and ``cholesky_ex`` reads
    the lower triangle; the two agree on a matrix that is symmetric bit for
    bit. The baselines factor products (K_bb + C, S = K A^-1 K) that are
    symmetric only up to rounding, so they factor the symmetrized matrix,
    as JAX does (the WISKI path keeps :func:`psd_safe_cholesky`).
    """
    return psd_safe_cholesky(0.5 * (mat + mat.mT), jitter=jitter, tries=tries)


def _nan_where_failed(chol: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    failed = torch.full_like(chol, float("nan")).tril()
    return torch.where((info != 0)[..., None, None], failed, chol)


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky with no jitter; where it fails, NaN in the lower
    triangle, as ``jnp.linalg.cholesky`` returns."""
    with f32_matmul_precision():
        chol, info = torch.linalg.cholesky_ex(mat)
    return _nan_where_failed(chol, info)


def spd_cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a matrix the math makes SPD (Q = I + L^T K L of the
    Woodbury MLL and the prediction caches), with no jitter; NaN in the
    lower triangle where it fails, as :func:`cholesky`.

    Routed by the tensor, as the JAX package routes its kernels by
    ``detach_interp``: a CUDA float32 tensor that does not require grad
    (K6 has no autograd rule) goes to kernel K6 (``blocked_cholesky_ex``),
    whose pivot flag says where it failed; any other tensor (the CPU,
    float64, one that requires grad) goes to :func:`cholesky`. Nothing is
    tried and caught.
    """
    if mat.device.type == "cuda" and mat.dtype == torch.float32 and not mat.requires_grad:
        chol, info = blocked_cholesky_ex(mat)
        return _nan_where_failed(chol, info)
    return cholesky(mat)


def tri_solve(chol: torch.Tensor, rhs: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """Triangular solve L x = rhs (or L^T x = rhs when trans)."""
    with f32_matmul_precision():
        if trans:
            return torch.linalg.solve_triangular(chol.mT, rhs, upper=True)
        return torch.linalg.solve_triangular(chol, rhs, upper=False)


def cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = rhs given the lower factor."""
    return tri_solve(chol, tri_solve(chol, rhs), trans=True)


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """log|A| from its lower Cholesky factor: 2 * sum(log diag L)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def chol_inverse(chol: torch.Tensor) -> torch.Tensor:
    """The dense inverse (L L^T)^{-1} from the lower factor."""
    n = chol.shape[-1]
    return cho_solve(chol, torch.eye(n, dtype=chol.dtype, device=chol.device).expand(chol.shape))


def inv_lower_transpose(chol: torch.Tensor) -> torch.Tensor:
    """L^{-T}: the inverse root B with (L L^T)^{-1} = B B^T."""
    n = chol.shape[-1]
    eye = torch.eye(n, dtype=chol.dtype, device=chol.device).expand(chol.shape)
    return tri_solve(chol, eye, trans=True)
