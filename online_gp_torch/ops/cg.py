"""Batched conjugate gradients, Lanczos and stochastic Lanczos quadrature
(port of ``online_gp_tpu/ops/cg.py``).

The large-grid (m > ``max_cholesky_size``) MLL and the rank-capped
predictive roots run on these. As in the JAX package, CG runs a fixed
number of iterations and freezes converged columns by a mask, and
Lanczos runs a fixed number of steps with full reorthogonalization and an
elementwise breakdown guard: no loop reads a value back to the host, so
a call queues its work on the card without waiting. Lanczos takes
leading batch dims, so that SLQ runs all its probes (and all outputs) as
one batch. Everything is differentiable by autograd.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def batched_cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    max_iters: int = 100,
    tol: float = 1e-2,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Solve A X = rhs for PSD A given only its MVM.

    Args:
      matvec: (..., m, k) -> (..., m, k) symmetric PSD product.
      rhs: (..., m, k) right-hand sides (k solved together).
      max_iters: the iteration count (every call runs all of them).
      tol: relative residual at which a column freezes (masked, not exited).

    Returns (..., m, k) approximate solves.
    """
    M = precond if precond is not None else (lambda v: v)
    rhs_norm = torch.sqrt(torch.sum(rhs * rhs, dim=-2, keepdim=True))
    stop = tol * torch.clamp(rhs_norm, min=1e-30)
    x = torch.zeros_like(rhs)
    r = rhs
    p = M(r)
    rz = torch.sum(r * p, dim=-2, keepdim=True)
    for _ in range(max_iters):
        Ap = matvec(p)
        denom = torch.sum(p * Ap, dim=-2, keepdim=True)
        alpha = rz / torch.clamp(denom, min=1e-30)
        res = torch.sqrt(torch.sum(r * r, dim=-2, keepdim=True))
        active = (res > stop).to(rhs.dtype)
        x = x + alpha * p * active
        r = r - alpha * Ap * active
        z = M(r)
        rz_new = torch.sum(r * z, dim=-2, keepdim=True)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
    return x


def lanczos(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    num_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-k Lanczos tridiagonalization with full reorthogonalization.

    Args:
      matvec: (..., m) -> (..., m) PSD product, batched over the leading dims.
      v0: (..., m) start vectors.
      num_iters: k.

    Returns Q (..., k, m) orthonormal Lanczos vectors, alpha (..., k),
    beta (..., k - 1).
    """
    k = num_iters
    eps = torch.finfo(v0.dtype).eps
    rows = [v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)]
    alphas, betas = [], []
    for i in range(k):
        q = rows[i]
        w = matvec(q)
        a = torch.sum(q * w, dim=-1)
        b_prev = betas[i - 1] if i > 0 else torch.zeros_like(a)
        w = w - a[..., None] * q
        if i > 0:
            w = w - b_prev[..., None] * rows[i - 1]
        # full reorthogonalization against the i + 1 vectors so far
        Q = torch.stack(rows, dim=-2)  # (..., i + 1, m)
        coeffs = torch.einsum("...jm,...m->...j", Q, w)
        w = w - torch.einsum("...jm,...j->...m", Q, coeffs)
        b = torch.linalg.vector_norm(w, dim=-1)
        # breakdown guard: once the Krylov space is exhausted the residual
        # is rounding noise; this beta, the later vectors and the later
        # (alpha, beta) are set to 0, a clean rank truncation of T
        ok = b > 100.0 * eps * (torch.abs(a) + b_prev + 1.0)
        b = torch.where(ok, b, torch.zeros_like(b))
        alphas.append(a)
        betas.append(b)
        if i + 1 < k:
            q_next = w / torch.clamp(b, min=1e-30)[..., None]
            rows.append(torch.where(ok[..., None], q_next, torch.zeros_like(w)))
    return torch.stack(rows, dim=-2), torch.stack(alphas, dim=-1), torch.stack(betas[: k - 1], dim=-1)


def _tridiag(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(alphas) + torch.diag_embed(betas, offset=1) + torch.diag_embed(betas, offset=-1)


def lanczos_root(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    num_iters: int,
) -> torch.Tensor:
    """Rank-k approximate root R (..., m, k) with A ~= R R^T, from the
    Lanczos relation A ~= Q^T T Q and T = V diag(lam) V^T."""
    Q, alphas, betas = lanczos(matvec, v0, num_iters)
    evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
    evals = torch.clamp(evals, min=0.0)
    return Q.mT @ (evecs * torch.sqrt(evals)[..., None, :])


def slq_logdet(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    probes: torch.Tensor,
    num_iters: int = 32,
) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of log|A| for PSD A.

    Args:
      matvec: (..., P, m) -> (..., P, m), batched over probes and any
        leading dims.
      probes: (..., P, m) Rademacher probes, drawn by the caller.

    Returns (...,): the mean over the P probes.
    """
    m = probes.shape[-1]
    _, alphas, betas = lanczos(matvec, probes, num_iters)
    evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
    evals = torch.clamp(evals, min=1e-30)
    w = evecs[..., 0, :] ** 2
    return torch.mean(torch.sum(w * torch.log(evals), dim=-1) * m, dim=-1)


def rademacher(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """+-1 entries with equal odds, drawn on the generator's device."""
    bits = torch.randint(0, 2, shape, generator=generator, device=generator.device)
    return (2 * bits - 1).to(dtype)
