"""Kernels K2 (``rank1_apply``) and K1 (``blocked_chunk``): the maintained-
root updates on the card, each beside its plain PyTorch version.

K2 replaces ``pallas_rank1_apply_batched``
(``online_gp_tpu/ops/pallas_root_update.py``): the per-point rank-1
update of ``wiski_condition`` at q = 1. K1 replaces
``pallas_blocked_chunk_batched`` with ``mode="flat"`` and ``sub=k``: one
rank-k chunk of ``wiski_stream``. The CUDA sources, with the design
notes (what bounds each kernel and what the Pallas design could not carry
over), are ``online_gp_torch/csrc/root_update.cu``.

Dispatch, by the tensors given: on the CPU the plain version runs; on
CUDA with float32 (int32 indices) the kernel launches; anything else
(float64 on CUDA, a tensor that requires grad, a non-contiguous tensor)
raises and names the plain version. There is no fallback.

On CUDA each wrapper updates its state tensors in place and returns them;
the plain versions return new tensors. Each wrapper counts its calls that
launched the kernel in its ``launches`` attribute (one per call; a call
is several CUDA launches, listed in the source).
"""

from __future__ import annotations

import ctypes

import torch

from online_gp_torch.ops import _build
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import blocked_factors, roots_apply_rank1_p

# What the kernels take: the recursion keeps a[k] and g[k] in shared
# memory beside two m-vectors, one block per output.
MAX_CHUNK = 1024
MAX_SHARED_BYTES = 232448
MAX_GRID_YZ = 65535

_lib = None


def _root_update_lib():
    global _lib
    if _lib is None:
        lib = _build.load("root_update")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ogp_rank1_apply.argtypes = [vp, vp, vp, vp, vp, i32, i32, vp]
        lib.ogp_rank1_apply.restype = i32
        lib.ogp_blocked_chunk.argtypes = [vp] * 9 + [i32] * 4 + [vp]
        lib.ogp_blocked_chunk.restype = i32
        lib.ogp_blocked_chunk_smem.argtypes = [i32, i32]
        lib.ogp_blocked_chunk_smem.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check_sizes(Bd: int, m: int) -> None:
    if Bd * m * m >= 2**31:
        raise ValueError(f"Bd * m * m = {Bd * m * m} does not fit the kernels' int32 sizes")
    if Bd > MAX_GRID_YZ // 2:
        raise ValueError(f"Bd = {Bd} exceeds the launch grid ({MAX_GRID_YZ // 2})")


# --------------------------------------------------------------------------
# K2: rank-1 apply
# --------------------------------------------------------------------------


def rank1_apply_plain(L: torch.Tensor, B: torch.Tensor, p: torch.Tensor):
    """Plain version of K2: :func:`roots_apply_rank1_p`. Its guard is
    |p| > 0 where the kernel's (the Pallas one's) is |p| > 1e-20; both are
    exact no-ops at p = 0."""
    return roots_apply_rank1_p(L, B, p)


def rank1_apply(L: torch.Tensor, B: torch.Tensor, p: torch.Tensor):
    """K2: L += c (L u) u^T, B += d (B u) u^T with u = p/|p| per output.

    Args:
      L, B: (Bd, m, m) root / inverse root; p: (Bd, m) = B^T v.

    Returns (L', B'). On CUDA, L and B are updated in place.
    """
    if _build.on_cpu(L, B, p):
        return rank1_apply_plain(L, B, p)
    _build.check_cuda_args("rank1_apply_plain", L=L, B=B, p=p)
    if L.dim() != 3 or L.shape[1] != L.shape[2] or B.shape != L.shape:
        raise ValueError(f"L, B must be (Bd, m, m) of one shape; got {tuple(L.shape)}, {tuple(B.shape)}")
    Bd, m = L.shape[0], L.shape[-1]
    if tuple(p.shape) != (Bd, m):
        raise ValueError(f"p must be ({Bd}, {m}); got {tuple(p.shape)}")
    _check_sizes(Bd, m)
    u = torch.empty((Bd, m), dtype=torch.float32, device=L.device)
    cd = torch.empty((Bd, 2), dtype=torch.float32, device=L.device)
    lib = _root_update_lib()
    p_ = _build.ptr
    rc = lib.ogp_rank1_apply(p_(L), p_(B), p_(p), p_(u), p_(cd), Bd, m, _build.stream_of(L))
    _build.launch_check(rc, "rank1_apply")
    rank1_apply.launches += 1
    return L, B


rank1_apply.launches = 0


# --------------------------------------------------------------------------
# K1: one blocked chunk of the root stream
# --------------------------------------------------------------------------


def blocked_chunk_plain(L: torch.Tensor, B: torch.Tensor, idx: torch.Tensor, wv: torch.Tensor):
    """Plain version of K1 (the JAX package's XLA ``chunk_step``):
    p0 = the stencil gather of B, then :func:`blocked_factors`, then
    L + (L R^T) U and B + (B P^T) U. Returns new (L', B')."""
    with f32_matmul_precision():
        p0 = torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()])
        U, Pm, R = blocked_factors(p0)
        new_L = L + (L @ R.mT) @ U
        new_B = B + (B @ Pm.mT) @ U
    return new_L, new_B


def blocked_chunk(L: torch.Tensor, B: torch.Tensor, idx: torch.Tensor, wv: torch.Tensor):
    """K1: k exact sequential rank-1 root updates with
    v_t = sum_p wv[b, t, p] e_{idx[t, p]}.

    Args:
      L, B: (Bd, m, m) root / inverse root.
      idx: (k, P) stencil indices in [0, m), shared by the outputs
        (int32 on CUDA).
      wv: (Bd, k, P) stencil weights already divided by sqrt(noise).

    Returns (L', B'). On CUDA, L and B are updated in place.
    """
    if _build.on_cpu(L, B, idx, wv):
        return blocked_chunk_plain(L, B, idx, wv)
    _build.check_cuda_args("blocked_chunk_plain", ints=("idx",), L=L, B=B, idx=idx, wv=wv)
    if L.dim() != 3 or L.shape[1] != L.shape[2] or B.shape != L.shape:
        raise ValueError(f"L, B must be (Bd, m, m) of one shape; got {tuple(L.shape)}, {tuple(B.shape)}")
    Bd, m = L.shape[0], L.shape[-1]
    if idx.dim() != 2 or tuple(wv.shape) != (Bd, *idx.shape):
        raise ValueError(f"idx must be (k, P) and wv (Bd, k, P); got {tuple(idx.shape)}, {tuple(wv.shape)}")
    k, P = idx.shape
    _check_sizes(Bd, m)
    lib = _root_update_lib()
    if k > MAX_CHUNK or lib.ogp_blocked_chunk_smem(k, m) > MAX_SHARED_BYTES:
        raise ValueError(f"chunk (k={k}, m={m}) exceeds what the K1 kernel takes (k <= {MAX_CHUNK}, "
                         f"(2m + 2k + 32) floats of shared memory <= {MAX_SHARED_BYTES} bytes)")
    dev = L.device
    factors = torch.empty((4, Bd, k, m), dtype=torch.float32, device=dev)  # p0, U, P, R
    T = torch.empty((Bd, 2, m, k), dtype=torch.float32, device=dev)
    p_ = _build.ptr
    rc = lib.ogp_blocked_chunk(
        p_(L), p_(B), p_(idx), p_(wv), p_(factors[0]), p_(factors[1]), p_(factors[2]),
        p_(factors[3]), p_(T), Bd, k, P, m, _build.stream_of(L),
    )
    _build.launch_check(rc, "blocked_chunk")
    blocked_chunk.launches += 1
    return L, B


blocked_chunk.launches = 0
