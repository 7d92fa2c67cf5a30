"""Kernel K6 (``blocked_cholesky``): a blocked Cholesky on the card,
beside its plain PyTorch version.

K6 replaces ``blocked_cholesky`` (``online_gp_tpu/ops/pallas_chol.py``):
the lower Cholesky factor of an SPD matrix by a right-looking blocked
algorithm with panels of 128 columns. On the card each panel is three
kernels: the diagonal tile factored by one block in inner panels of 32
columns (one warp each, which also inverts its 32 x 32 block), the solve
of the rows below, and the trailing update over the lower tiles only. The CUDA
source, with the design notes, is ``online_gp_torch/csrc/chol.cu``.

The Pallas kernel's pivot guard rsqrt(max(a_jj, 1e-30)) gives finite
numbers for a matrix that is not SPD. So K6 also reports, per matrix, an
``info`` that is nonzero where some pivot before the guard was <= 0 or not
finite (:func:`blocked_cholesky_ex`), the signal
``torch.linalg.cholesky_ex`` gives. With it
:func:`online_gp_torch.ops.chol.spd_cholesky` factors Q = I + L^T K L, the
Woodbury MLL's and the prediction caches' matrix, with K6 on the card
(the JAX package factors that Q with ``jnp.linalg.cholesky``).

Dispatch, by the tensor given: on the CPU the plain version runs; on CUDA
with float32 the kernel launches; anything else (float64 on CUDA, a tensor
that requires grad, a non-contiguous tensor) raises and names the plain
version. There is no fallback. ``blocked_cholesky.launches`` counts the
calls of either wrapper that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from online_gp_torch.ops import _build
from online_gp_torch.ops.precision import f32_matmul_precision

# The panel width the kernel takes (the one chip_smoke.py checks on the card):
# a panel tile sits in shared memory (kB in csrc/chol.cu).
KERNEL_BLOCK = 128
# The kernels after the first of a call use programmatic dependent launch,
# so each is scheduled while the one before it runs. chip_smoke.py times
# K6 with this off too: the measurement that chose it.
PROGRAMMATIC_LAUNCH = True

_lib = None


def _chol_lib():
    global _lib
    if _lib is None:
        lib = _build.load("chol")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ogp_blocked_cholesky.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
        lib.ogp_blocked_cholesky.restype = i32
        _lib = lib
    return _lib


def blocked_cholesky_plain_ex(q: torch.Tensor, block: int = 128):
    """Plain version of K6, the same blocked algorithm as PyTorch ops: per
    panel, ``block`` elimination steps with the pivot guard
    rsqrt(max(a_jj, 1e-30)) and the rows of V = L_kk^{-1} by forward
    substitution, then P = A_below V^T and A_trail -= P P^T. The last
    panel is narrower where m is not a multiple of ``block``. Returns the
    lower factor, its strict upper triangle exactly 0, and the int32
    ``info`` of shape q.shape[:-2]: 1 where some pivot a_jj before the
    guard was <= 0 or not finite, else 0."""
    m = q.shape[-1]
    out = q.clone()
    eye = torch.eye(block, dtype=q.dtype, device=q.device)
    failed = torch.zeros(q.shape[:-2], dtype=torch.bool, device=q.device)
    with f32_matmul_precision():
        for lo in range(0, m, block):
            hi = min(lo + block, m)
            bs = hi - lo
            A = out[..., lo:hi, lo:hi].clone()
            L = torch.zeros_like(A)
            V = torch.zeros_like(A)
            for j in range(bs):
                piv = A[..., j, j]
                failed |= ~((piv > 0) & torch.isfinite(piv))
                inv = torch.rsqrt(torch.clamp(piv, min=1e-30))[..., None]
                col = A[..., j:, j] * inv
                L[..., j:, j] = col
                A[..., j + 1 :, j + 1 :] -= col[..., 1:, None] * col[..., None, 1:]
                below = (L[..., j, None, :j] @ V[..., :j, :])[..., 0, :]
                V[..., j, :] = (eye[j, :bs] - below) * inv
            out[..., lo:hi, lo:hi] = L
            if hi < m:
                P = out[..., hi:, lo:hi] @ V.mT
                out[..., hi:, lo:hi] = P
                out[..., hi:, hi:] -= P @ P.mT
    return torch.tril(out), failed.to(torch.int32)


def blocked_cholesky_plain(q: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Plain version of K6 without the flag: :func:`blocked_cholesky_plain_ex`'s
    factor."""
    return blocked_cholesky_plain_ex(q, block)[0]


def blocked_cholesky_ex(q: torch.Tensor, block: int = 128):
    """K6 with its failure flag: (L, info).

    Args:
      q: (..., m, m); any leading dims are a batch, as the JAX function
        vmaps them (on CUDA they are flattened into one batch dim of the
        kernel and restored).
      block: panel width; on CUDA 128.

    Returns the lower factor, a new tensor of q's shape with its strict
    upper triangle exactly 0, and the int32 ``info`` of shape
    ``q.shape[:-2]``, nonzero where some pivot before the guard was <= 0 or
    not finite (there the factor is meaningless).
    """
    if _build.on_cpu(q):
        return blocked_cholesky_plain_ex(q, block)
    _build.check_cuda_args("blocked_cholesky_plain_ex", q=q)
    if q.dim() < 2 or q.shape[-1] != q.shape[-2]:
        raise ValueError(f"q must be (..., m, m); got {tuple(q.shape)}")
    if block != KERNEL_BLOCK:
        raise ValueError(f"the K6 kernel takes block {KERNEL_BLOCK}; got {block} "
                         "(blocked_cholesky_plain takes any)")
    m = q.shape[-1]
    q3 = q.reshape(-1, m, m)
    Bd = q3.shape[0]
    if Bd * m * m >= 2**31 or Bd > 65535:
        raise ValueError(f"(Bd, m) = ({Bd}, {m}) exceeds the kernel's int32 sizes and grid")
    out = torch.empty_like(q3)
    if out.numel() == 0:
        return out.view(q.shape), torch.zeros(q.shape[:-2], dtype=torch.int32, device=q.device)
    info = torch.empty((Bd,), dtype=torch.int32, device=q.device)  # chol_init_kernel zeros it
    W = torch.empty((Bd, block // 32, 32, 32), dtype=torch.float32, device=q.device)
    p_ = _build.ptr
    rc = _chol_lib().ogp_blocked_cholesky(p_(q3), p_(out), p_(W), p_(info), Bd, m,
                                          int(PROGRAMMATIC_LAUNCH), _build.stream_of(q))
    _build.launch_check(rc, "blocked_cholesky")
    blocked_cholesky.launches += 1
    return out.view(q.shape), info.view(q.shape[:-2])


def blocked_cholesky(q: torch.Tensor, block: int = 128) -> torch.Tensor:
    """K6: the lower Cholesky factor of SPD ``q`` (:func:`blocked_cholesky_ex`
    without the flag; the same launches)."""
    return blocked_cholesky_ex(q, block)[0]


# one count for both entries: each call of either that launched the kernel
blocked_cholesky.launches = 0
