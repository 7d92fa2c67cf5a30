"""Maintained matrix roots with exact O(m^2 q) rank-q updates (port of
``online_gp_tpu/ops/root_update.py``, plain paths).

The root L and inverse root B of the SKI Gram matrix A = W D^{-1} W^T
(A = L L^T, A^{-1} = B B^T) absorb A + v v^T exactly: with the thin SVD
p = B^T v = U_q S V^T,

    L' = L (I + U_q diag(c) U_q^T),  c = sqrt(S^2+1) - 1
    B' = B (I + U_q diag(d) U_q^T),  d = 1/sqrt(S^2+1) - 1

so nothing bigger than q x q is factorized (q = 1 for point streams).

A stream of n rank-1 updates is blocked into rank-k chunks
(:func:`roots_stream_blocked`): a chunk of k steps is
L_0 (I + R^T U), B_0 (I + P^T U) with the rows of U, P, R from the O(k m)
per-step recursion :func:`blocked_factors`, so the O(m^2) work is two
products per chunk. Each chunk runs through kernel K1
(:func:`online_gp_torch.ops.cuda_root_update.blocked_chunk`) on CUDA and
its plain version on the CPU. PyTorch runs eagerly, so the JAX package's
``lax.scan`` over chunks is a Python loop here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from online_gp_torch.logging.timing import spanned
from online_gp_torch.ops.chol import inv_lower_transpose, psd_safe_cholesky
from online_gp_torch.ops.interp import _densify_rows
from online_gp_torch.ops.precision import f32_matmul_precision


class RootCache(NamedTuple):
    """A = mat = root @ root^T with inv_root @ inv_root^T = A^{-1}.

    ``mat`` may be ``None`` (slim mode, :func:`root_cache_slim`): the
    exact Gram accumulator is dropped and the updates touch only the two
    roots."""

    mat: Optional[torch.Tensor]  # (..., m, m) or None
    root: torch.Tensor  # (..., m, m)
    inv_root: torch.Tensor  # (..., m, m)


def root_cache_init(mat: torch.Tensor, jitter: float = 1e-4) -> RootCache:
    """Roots from a dense PSD matrix via a jittered Cholesky (the roots
    then track A + eps I while A is rank deficient early in a stream)."""
    chol = psd_safe_cholesky(mat, jitter=jitter).contiguous()
    return RootCache(mat=mat, root=chol, inv_root=inv_lower_transpose(chol).contiguous())


def root_cache_slim(cache: RootCache) -> RootCache:
    """Drop the exact Gram accumulator from the streaming state."""
    return cache._replace(mat=None)


def root_cache_rebuild_mat(cache: RootCache) -> RootCache:
    """Rebuild A = root @ root^T for a slim cache (no-op when present)."""
    if cache.mat is not None:
        return cache
    with f32_matmul_precision():
        mat = cache.root @ cache.root.mT
    return cache._replace(mat=mat)


def root_cache_expand(cache: RootCache, batch_shape) -> RootCache:
    """The cache broadcast along new leading batch dims ``batch_shape``
    (views, no copy; a slim cache's ``mat`` stays None)."""
    return RootCache(*(None if x is None else x.expand(*batch_shape, *x.shape) for x in cache))


def root_cache_update(cache: RootCache, v: torch.Tensor) -> RootCache:
    """Rank-q update A <- A + v v^T with O(m^2 q) root maintenance.

    Args:
      cache: current roots.
      v: (..., m, q) update vectors.
    """
    with f32_matmul_precision():
        L, B = cache.root, cache.inv_root
        p = B.mT @ v  # (..., m, q)
        new_root, new_inv_root = roots_apply_rank_q_p(L, B, p)
        new_mat = None if cache.mat is None else cache.mat + v @ v.mT
    return RootCache(mat=new_mat, root=new_root, inv_root=new_inv_root)


def roots_apply_rank_q_p(L: torch.Tensor, B: torch.Tensor, p: torch.Tensor):
    """The root update of :func:`root_cache_update` given p = B^T v (..., m,
    q): L' = L (I + U diag(c) U^T), B' = B (I + U diag(d) U^T) from the thin
    SVD of p. L and B may be (..., rows, m), a shard's rows: each row's
    update needs its own entries and p only."""
    with f32_matmul_precision():
        q = p.shape[-1]
        floor = torch.tensor(1e-20, dtype=p.dtype, device=p.device)
        if q == 1:
            s2 = torch.sum(p * p, dim=(-2, -1))[..., None]  # (..., 1)
            s = torch.sqrt(s2)
            U = p / torch.maximum(s, floor)[..., None, :]
        else:
            # thin SVD of p from the q x q Gram: p^T p = V diag(S^2) V^T
            gram = p.mT @ p
            s2, V = torch.linalg.eigh(gram)
            s2 = torch.clamp(s2, min=0.0)
            s = torch.sqrt(s2)
            U = (p @ V) / torch.maximum(s, floor)[..., None, :]
        valid = (s > 0).to(p.dtype)  # a zero singular value contributes nothing
        c = (torch.sqrt(s2 + 1.0) - 1.0) * valid
        d = (1.0 / torch.sqrt(s2 + 1.0) - 1.0) * valid
        new_root = L + ((L @ U) * c[..., None, :]) @ U.mT
        new_inv_root = B + ((B @ U) * d[..., None, :]) @ U.mT
    return new_root, new_inv_root


def roots_apply_rank1_p(L: torch.Tensor, B: torch.Tensor, p: torch.Tensor):
    """Rank-1 root update given p = B^T v directly:

        L' = L + c (L u) u^T,   B' = B + d (B u) u^T,
        u = p/|p|, c = sqrt(|p|^2+1)-1, d = 1/sqrt(|p|^2+1)-1

    (c = d = 0 when p = 0). L, B: (..., m, m); p: (..., m). Returns
    new (L', B'). This is the plain version of kernel K2."""
    with f32_matmul_precision():
        s2 = torch.sum(p * p, dim=-1, keepdim=True)
        s = torch.sqrt(s2)
        u = p / torch.clamp(s, min=1e-20)
        valid = (s > 0).to(p.dtype)
        c = (torch.sqrt(s2 + 1.0) - 1.0) * valid
        d = (1.0 / torch.sqrt(s2 + 1.0) - 1.0) * valid
        Lu = (L @ u[..., None])[..., 0]
        Bu = (B @ u[..., None])[..., 0]
        new_L = L + (c * Lu)[..., :, None] * u[..., None, :]
        new_B = B + (d * Bu)[..., :, None] * u[..., None, :]
    return new_L, new_B


def stencil_rows(idx: torch.Tensor, wv: torch.Tensor, m: int) -> torch.Tensor:
    """Densify sparse stencil rows: (k, P) indices/weights -> (k, m) with
    row t = sum_p wv[t, p] e_{idx[t, p]} (duplicates summed)."""
    return _densify_rows(idx.long(), wv, m)


def _factor_step(p0_t: torch.Tensor, U: torch.Tensor, Pm: torch.Tensor, R: torch.Tensor):
    """One step of the chunk recursion: given the raw row p0_t (..., m) and
    the factor rows so far (any rows past them zero), returns the step's
    rows (u, p_col, r_col), each (..., m)."""
    a = (Pm @ p0_t[..., None])[..., 0]
    p = p0_t + (U.mT @ a[..., None])[..., 0]
    s2 = torch.sum(p * p, dim=-1, keepdim=True)
    s = torch.sqrt(s2)
    u = p / torch.clamp(s, min=1e-20)
    valid = (s > 0).to(p.dtype)
    c = (torch.sqrt(s2 + 1.0) - 1.0) * valid
    d = (1.0 / torch.sqrt(s2 + 1.0) - 1.0) * valid
    g = (U @ u[..., None])[..., 0]
    return u, d * (u + (Pm.mT @ g[..., None])[..., 0]), c * (u + (R.mT @ g[..., None])[..., 0])


def blocked_factors(p0: torch.Tensor):
    """Factor recursion of one rank-k blocked chunk: given p0 (..., k, m)
    with row t = B_start^T v_t, returns (U, P, R), each (..., k, m) in row
    layout, such that the chunk's k sequential rank-1 updates compose to
    L (I + R^T U), B (I + P^T U). The rows are filled in place, one per
    step (no autograd through this loop: :func:`blocked_factors_stacked`
    is the form autograd takes)."""
    k = p0.shape[-2]
    U = torch.zeros_like(p0)
    Pm = torch.zeros_like(p0)
    R = torch.zeros_like(p0)
    with f32_matmul_precision():
        for t in range(k):
            U[..., t, :], Pm[..., t, :], R[..., t, :] = _factor_step(p0[..., t, :], U, Pm, R)
    return U, Pm, R


def blocked_factors_stacked(p0: torch.Tensor):
    """:func:`blocked_factors` in a form autograd takes: each step appends
    its rows with ``torch.cat`` and writes nothing in place, so a step
    sums over the rows so far, not over k zero-padded rows (equal up to
    rounding)."""
    U = Pm = R = p0[..., :0, :]
    with f32_matmul_precision():
        for t in range(p0.shape[-2]):
            rows = _factor_step(p0[..., t, :], U, Pm, R)
            U, Pm, R = (torch.cat([X, row[..., None, :]], dim=-2) for X, row in zip((U, Pm, R), rows))
    return U, Pm, R


def blocked_chunk_stacked(L: torch.Tensor, B: torch.Tensor, idx: torch.Tensor, wv: torch.Tensor):
    """One rank-k chunk of the root stream in a form autograd takes: K1's
    plain math (the stencil gather, :func:`blocked_factors_stacked`, the
    two applies), never a kernel. L, B: (Bd, m, m); idx: (k, P); wv:
    (Bd, k, P). Returns new (L', B')."""
    with f32_matmul_precision():
        p0 = torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()])
        U, Pm, R = blocked_factors_stacked(p0)
        return L + (L @ R.mT) @ U, B + (B @ Pm.mT) @ U


CHUNK_MODES = ("flat", "coord")


def chunk_sub(k: int, sub: Optional[int], mode: str) -> int:
    """The sub-block size of a rank-k chunk (``sub=None`` is k, the flat
    recursion); raises ValueError unless ``sub`` divides k and ``mode`` is
    one of :data:`CHUNK_MODES`, as ``pallas_blocked_chunk_batched`` does."""
    sub = k if sub is None else int(sub)
    if sub < 1 or k % sub:
        raise ValueError(f"sub={sub} must divide the chunk rank k={k}")
    if mode not in CHUNK_MODES:
        raise ValueError(f"unknown chunk-kernel mode {mode!r} (flat/coord)")
    return sub


def blocked_factors_sub(p0: torch.Tensor, sub: int):
    """Two-level form of :func:`blocked_factors`: the flat recursion runs
    inside sub-blocks of ``sub`` rows (``sub`` divides k). Sub-block j's raw
    rows are first corrected by the earlier sub-blocks' operators in stream
    order (q <- q + (q P_i^T) U_i), then factored locally. The chunk is
    L (I + R_0^T U_0) ... (I + R_{nb-1}^T U_{nb-1}), and the same for B with
    P: apply the returned rows one sub-block at a time, in order. Returns
    (U, P, R), each (..., k, m)."""
    k = p0.shape[-2]
    parts = []
    with f32_matmul_precision():
        for lo in range(0, k, sub):
            rows = p0[..., lo : lo + sub, :]
            for U_i, P_i, _ in parts:
                rows = rows + (rows @ P_i.mT) @ U_i
            parts.append(blocked_factors(rows))
    return tuple(torch.cat(f, dim=-2) for f in zip(*parts))


def collapse_sub_factors(U: torch.Tensor, Pm: torch.Tensor, R: torch.Tensor, sub: int):
    """The rows of :func:`blocked_factors_sub` as one rank-k operator: with
    G_j = I + R_j^T U_j for sub-block j (rows [j sub, j sub + sub)), the
    product G_0 G_1 ... G_{nb-1} is I + Rc^T U, where

        Rc_j = R_j + sum_{i<j} (R_j U_i^T) Rc_i,

    and the same for P. So the chunk is L (I + Rc^T U), B (I + Pc^T U): one
    apply, as for the flat recursion. Returns (Rc, Pc), each (..., k, m)."""
    k = U.shape[-2]
    Rc, Pc = R.clone(), Pm.clone()
    with f32_matmul_precision():
        for lo in range(sub, k, sub):
            rows, done = slice(lo, lo + sub), slice(0, lo)
            Rc[..., rows, :] = R[..., rows, :] + (R[..., rows, :] @ U[..., done, :].mT) @ Rc[..., done, :]
            Pc[..., rows, :] = Pm[..., rows, :] + (Pm[..., rows, :] @ U[..., done, :].mT) @ Pc[..., done, :]
    return Rc, Pc


def blocked_factors_coord(p0: torch.Tensor):
    """Coordinate form of :func:`blocked_factors`: every factor row lies in
    the span of the rows of p0, so the recursion runs on k-dim coordinates
    (u_t = Ut[t] p0, p_t = Pt[t] p0, r_t = Rt[t] p0) with inner products
    taken through M = p0 p0^T. The chunk is L (I + p0^T (Rt^T Ut) p0),
    B (I + p0^T (Pt^T Ut) p0). Returns (Ut, Pt, Rt), each (..., k, k).
    The guards are the Pallas kernel's: s^2 = max(pi^T M pi, 0), and
    u = 0 when s <= 1e-20."""
    k = p0.shape[-2]
    shape = (*p0.shape[:-2], k, k)
    Ut, Pt, Rt = (torch.zeros(shape, dtype=p0.dtype, device=p0.device) for _ in range(3))
    eye = torch.eye(k, dtype=p0.dtype, device=p0.device)
    with f32_matmul_precision():
        M = p0 @ p0.mT
        for t in range(k):
            a = (Pt @ M[..., t, :, None])[..., 0]  # rows >= t are zero
            pi = eye[t] + (Ut.mT @ a[..., None])[..., 0]
            mpi = (M @ pi[..., None])[..., 0]
            s2 = torch.clamp(torch.sum(pi * mpi, dim=-1, keepdim=True), min=0.0)
            s = torch.sqrt(s2)
            inv_s = torch.where(s > 1e-20, 1.0 / torch.clamp(s, min=1e-20), torch.zeros_like(s))
            alpha = pi * inv_s
            c = torch.sqrt(s2 + 1.0) - 1.0
            d = 1.0 / torch.sqrt(s2 + 1.0) - 1.0
            g = (Ut @ (mpi * inv_s)[..., None])[..., 0]
            p_col = d * (alpha + (Pt.mT @ g[..., None])[..., 0])
            r_col = c * (alpha + (Rt.mT @ g[..., None])[..., 0])
            Ut[..., t, :] = alpha
            Pt[..., t, :] = p_col
            Rt[..., t, :] = r_col
    return Ut, Pt, Rt


def pad_and_chunk_stream(idx: torch.Tensor, wv: torch.Tensor, block: int):
    """Zero-pad a stencil stream to a multiple of the chunk rank and
    reshape to (nc, k, P). Zero-weight padding points are exact no-ops in
    the blocked recursion (p0 = 0, so u = 0 and c = d = 0)."""
    n, P = idx.shape
    k = int(min(block, max(n, 1)))
    pad = (-n) % k
    if pad:
        idx = torch.cat([idx, idx.new_zeros((pad, P))], dim=0)
        wv = torch.cat([wv, wv.new_zeros((pad, P))], dim=0)
    nc = (n + pad) // k
    return idx.reshape(nc, k, P), wv.reshape(nc, k, P), k


@spanned("sync.stencil_check")
def check_stencil(idx: torch.Tensor, m: int) -> None:
    """Raise unless every stencil index lies in [0, m) (one host sync)."""
    if idx.numel() and bool(((idx < 0) | (idx >= m)).any()):
        raise ValueError(f"stencil indices must lie in [0, {m})")


@spanned("roots_stream")
def roots_stream_blocked_batched(
    L: torch.Tensor,
    B: torch.Tensor,
    idx: torch.Tensor,
    wv: torch.Tensor,
    block: int = 32,
    differentiable: bool = False,
):
    """Sequential rank-1 root updates over a whole stream, in rank-``block``
    chunks, batched over outputs.

    Computes exactly the n-step recursion of :func:`roots_apply_rank1_p`
    over v_t = sum_p wv[t, p] e_{idx[t, p]} (the SKI stencil), one chunk
    per call of kernel K1, which on CUDA updates ``L`` and ``B`` in place:
    treat the inputs as consumed. With ``differentiable`` every chunk is
    :func:`blocked_chunk_stacked` instead, on any device: autograd runs
    through it, K1 is never called and nothing is updated in place (the
    JAX package's ``use_pallas=False``).

    Args:
      L, B: (Bd, m, m) roots; idx: (n, P) stencil indices shared by the
        outputs; wv: (Bd, n, P) per-output weights (already / sqrt(noise)).

    Returns (L', B') after all n updates, in stream order.
    """
    from online_gp_torch.ops.cuda_root_update import blocked_chunk

    Bd, m = L.shape[0], L.shape[-1]
    n, P = idx.shape
    check_stencil(idx, m)
    idx_c, _, k = pad_and_chunk_stream(idx, wv[0], block)
    pad = (-n) % k
    if pad:
        wv = torch.cat([wv, wv.new_zeros((Bd, pad, P))], dim=1)
    nc = idx_c.shape[0]
    idx_c = idx_c.to(torch.int32).contiguous()
    wv_c = wv.reshape(Bd, nc, k, P).transpose(0, 1).contiguous()  # (nc, Bd, k, P)
    L, B = L.contiguous(), B.contiguous()
    chunk = blocked_chunk_stacked if differentiable else blocked_chunk
    for c in range(nc):
        L, B = chunk(L, B, idx_c[c], wv_c[c])
    return L, B


def roots_stream_blocked(L, B, idx, wv, block: int = 32):
    """Single-output :func:`roots_stream_blocked_batched`: L, B (m, m);
    wv (n, P). Returns (L', B'); on CUDA, L and B are updated in place."""
    Lb, Bb = roots_stream_blocked_batched(L[None], B[None], idx, wv[None], block=block)
    return Lb[0], Bb[0]
