"""Kernels K2 (``rank1_apply``), K1 and K5 (``blocked_chunk``) and K4
(``rank1_update``, ``fused_root_cache_update``): the maintained-root
updates on the card, each beside its plain PyTorch version.

K2 replaces ``pallas_rank1_apply_batched``
(``online_gp_tpu/ops/pallas_root_update.py``): the per-point rank-1
update of ``wiski_condition`` at q = 1. K1 replaces
``pallas_blocked_chunk_batched`` with ``mode="flat"`` and ``sub=k``: one
rank-k chunk of ``wiski_stream``. K5 is the same function's two other
recursions, ``sub < k`` and ``mode="coord"``, as options of
``blocked_chunk``. K4 replaces ``pallas_rank1_update(_slim)(_batched)``
and their dispatcher ``pallas_root_cache_update``: the dense-v rank-1
update with p = B^T v computed on the card. The CUDA sources, with the
design notes (what bounds each kernel and what the Pallas design could
not carry over), are ``online_gp_torch/csrc/root_update.cu``.

K2 has a row-shard entry, :func:`rank1_apply_rows` (the same row kernel
over a shard's rows, for ``parallel/grid.py``'s grid-sharded
``wiski_condition``). K1's three stages are also wrappers of their own, for roots whose rows are
sharded over processes (``parallel/mesh.py::sharded_stream_blocked``):
:func:`chunk_gather_rows` (the partial p0 of a shard's rows),
:func:`chunk_factors` (the recursion on the summed p0) and
:func:`chunk_apply_rows` (the apply on a shard's rows), each beside its
plain version and counting its own ``launches`` (``chunk_factors`` also
``cluster_launches``, ``grid_cluster_launches`` and ``spread_launches``).

K1's apply (X += (X A^T) U for (X, A) = (L, R), (B, P)), which every
wrapper here that updates L and B ends with, also runs on clusters:
:func:`chunk_apply_plan` gives a 64-row tile of one X to 8 blocks, each
taking its columns of the tile, the partial products X A^T summed over
the cluster; where T (64 x k) does not fit a block's shared memory
beside the ring (k > 544) the two tiled kernels run it instead. Every
apply launched adds one to
``chunk_apply_plan.launches`` (on clusters) or
``chunk_apply_plan.tiled_launches``, and to
``chunk_apply_plan.shapes[(Bd, rows, m, k)]``.

K1's recursion runs on thread-block clusters: :func:`chunk_cluster_plan`
splits each output's m columns over 8 blocks that keep their columns of
the factor rows U, P, R in shared memory (``chunk_recursion_carried_kernel``,
one cluster exchange a step, the dots P_j . p0_t carried in the raw rows),
or, where one cluster's blocks cannot hold them (m > 1,120 at k = 128),
over G = 2 to 8 such clusters whose sums meet in device memory
(``chunk_recursion_grid_kernel``: G = 4 at m = 4,096, 8 up to m = 8,960).
The G clusters of an output wait on each other, so they launch in waves of
the outputs the card holds at once (``ogp_chunk_grid_capacity``). A chunk
that 8 clusters cannot hold, or whose G clusters the card cannot hold at
once, runs spread over the card (``chunk_recursion_spread_kernel``): as
many clusters of 8 as the card holds at once, up to 16, each block keeping
in shared memory U, P and R, else U alone, else none, and the rest in the
outputs in device memory; every k <= 1,024 and every m the card's memory
holds has such a plan. K5 sub runs its whole two-level recursion,
corrections and collapse to one rank-k operator included, in one cluster
kernel on K1's layout, so wherever :func:`chunk_cluster_plan` holds the
chunk on one cluster, and one sub-block at a time elsewhere (each by K1's
route at k = sub). Those rules are by shape and the card's capacity:
nothing is tried and caught. :func:`~online_gp_torch.ops._build.route`
decides each shape's route once, on rules ``K1``, checking each plan's
shared memory against the kernel's layout (``ogp_chunk_cluster_smem``,
``ogp_chunk_spread_smem``, ``ogp_chunk_apply_smem``) before the first
launch and raising RuntimeError if they differ.

Dispatch, by the tensors given: on the CPU the plain version runs; on
CUDA with float32 (int32 indices) the kernel launches; anything else
(float64 on CUDA, a tensor that requires grad, a non-contiguous tensor)
raises TypeError and names the plain version. The kernels take 64-bit
element offsets, so no size of the roots is refused; a shape no kernel
takes (a batch past the launch grid, k past what a spread block holds)
raises ValueError; a failed launch, or a cluster the card cannot
schedule, raises RuntimeError. There is no fallback.

On CUDA each wrapper updates its state tensors in place and returns them;
the plain versions return new tensors. Each wrapper counts its calls that
launched the kernel in its ``launches`` attribute (one per call; a call
is several CUDA launches, listed in the source); ``blocked_chunk`` counts
K1 there (and the K1 calls whose recursion ran on clusters in
``cluster_launches``, of them those on G > 1 clusters in
``grid_cluster_launches``, the rest by the carried kernel; those spread
over the card in ``spread_launches``) and K5 in ``sub_launches`` (of them, those on the
fused cluster kernel in ``sub_cluster_launches``) and ``coord_launches``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from online_gp_torch.ops import _build
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import (
    RootCache,
    blocked_factors,
    blocked_factors_coord,
    blocked_factors_sub,
    chunk_sub,
    root_cache_update,
    roots_apply_rank1_p,
)

# What the kernels take. The recursion's shape rules are chunk_cluster_plan
# and, past it, the spread plan of K1 (every k <= MAX_CHUNK); the coordinate
# recursion keeps six k x k triangles in shared memory. Both within
# MAX_SHARED_BYTES of dynamic shared memory per block.
MAX_CHUNK = 1024
MAX_SHARED_BYTES = _build.MAX_SHARED_BYTES

_lib = None


def _root_update_lib():
    global _lib
    if _lib is None:
        lib = _build.load("root_update")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ogp_rank1_apply.argtypes = [vp, vp, vp, vp, i32, i32, vp]
        lib.ogp_rank1_apply.restype = i32
        lib.ogp_rank1_apply_rows.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
        lib.ogp_rank1_apply_rows.restype = i32
        lib.ogp_blocked_chunk.argtypes = [vp] * 10 + [i32] * 9 + [vp]
        lib.ogp_blocked_chunk.restype = i32
        lib.ogp_chunk_cluster_smem.argtypes = [i32] * 4
        lib.ogp_chunk_cluster_smem.restype = ctypes.c_longlong
        lib.ogp_chunk_grid_capacity.argtypes = [i32] * 4
        lib.ogp_chunk_grid_capacity.restype = i32
        lib.ogp_chunk_spread_smem.argtypes = [i32] * 5
        lib.ogp_chunk_spread_smem.restype = ctypes.c_longlong
        lib.ogp_chunk_spread_capacity.argtypes = [i32] * 5
        lib.ogp_chunk_spread_capacity.restype = i32
        lib.ogp_rank1_update_tiles.argtypes = [i32]
        lib.ogp_rank1_update_tiles.restype = i32
        lib.ogp_rank1_update.argtypes = [vp] * 6 + [i32, i32, vp]
        lib.ogp_rank1_update.restype = i32
        lib.ogp_blocked_chunk_sub.argtypes = [vp] * 11 + [i32] * 10 + [vp]
        lib.ogp_blocked_chunk_sub.restype = i32
        lib.ogp_blocked_chunk_sub_cluster.argtypes = [vp] * 9 + [i32] * 7 + [vp]
        lib.ogp_blocked_chunk_sub_cluster.restype = i32
        lib.ogp_blocked_chunk_coord_smem.argtypes = [i32]
        lib.ogp_blocked_chunk_coord_smem.restype = ctypes.c_longlong
        lib.ogp_blocked_chunk_coord.argtypes = [vp] * 9 + [i32] * 5 + [vp]
        lib.ogp_blocked_chunk_coord_splits.argtypes = []
        lib.ogp_blocked_chunk_coord_splits.restype = i32
        lib.ogp_blocked_chunk_coord.restype = i32
        lib.ogp_chunk_gather_rows.argtypes = [vp] * 4 + [i32] * 6 + [vp]
        lib.ogp_chunk_gather_rows.restype = i32
        lib.ogp_chunk_factors.argtypes = [vp] * 5 + [i32] * 7 + [vp]
        lib.ogp_chunk_factors.restype = i32
        lib.ogp_chunk_apply_rows.argtypes = [vp] * 6 + [i32] * 5 + [vp]
        lib.ogp_chunk_apply_rows.restype = i32
        lib.ogp_chunk_apply_smem.argtypes = [i32] * 3
        lib.ogp_chunk_apply_smem.restype = ctypes.c_longlong
        _lib = lib
    return _lib


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
    _build.check_grid(Bd, 2)
    s2 = torch.empty((Bd,), dtype=torch.float32, device=L.device)
    lib = _root_update_lib()
    p_ = _build.ptr
    rc = lib.ogp_rank1_apply(p_(L), p_(B), p_(p), p_(s2), Bd, m, _build.stream_of(L))
    _build.launch_check(rc, "rank1_apply")
    rank1_apply.launches += 1
    return L, B


rank1_apply.launches = 0


def rank1_apply_rows_plain(L: torch.Tensor, B: torch.Tensor, p: torch.Tensor):
    """Plain version of :func:`rank1_apply_rows`: :func:`roots_apply_rank1_p`,
    which takes a shard's (..., rows, m) as it takes (..., m, m)."""
    return roots_apply_rank1_p(L, B, p)


def rank1_apply_rows(L: torch.Tensor, B: torch.Tensor, p: torch.Tensor):
    """K2 on a row shard: the rows of L += c (L u) u^T, B += d (B u) u^T
    with u = p/|p|, for roots whose m rows are sharded over processes
    (``parallel/grid.py``). A row's update needs only its own entries and
    p, so each shard applies the whole update to its rows.

    Args:
      L, B: (Bd, rows, m) the shard's rows of the root and inverse root.
      p: (Bd, m) = B^T v, summed over every shard's rows.

    Returns (L', B'). On CUDA, L and B are updated in place.
    """
    if _build.on_cpu(L, B, p):
        return rank1_apply_rows_plain(L, B, p)
    _build.check_cuda_args("rank1_apply_rows_plain", L=L, B=B, p=p)
    if L.dim() != 3 or B.shape != L.shape:
        raise ValueError(f"L, B must be (Bd, rows, m) of one shape; got {tuple(L.shape)}, {tuple(B.shape)}")
    Bd, rows, m = L.shape
    if tuple(p.shape) != (Bd, m):
        raise ValueError(f"p must be ({Bd}, {m}); got {tuple(p.shape)}")
    _build.check_grid(Bd, 2)
    s2 = torch.empty((Bd,), dtype=torch.float32, device=L.device)
    p_ = _build.ptr
    rc = _root_update_lib().ogp_rank1_apply_rows(p_(L), p_(B), p_(p), p_(s2), Bd, rows, m, _build.stream_of(L))
    _build.launch_check(rc, "rank1_apply_rows")
    rank1_apply_rows.launches += 1
    return L, B


rank1_apply_rows.launches = 0


# --------------------------------------------------------------------------
# K4: the dense-v rank-1 update
# --------------------------------------------------------------------------


def rank1_update_plain(L: torch.Tensor, B: torch.Tensor, A, v: torch.Tensor):
    """Plain version of K4: :func:`root_cache_update` at q = 1. Returns
    new (L', B', A'), with A' None when A is None."""
    new = root_cache_update(RootCache(mat=A, root=L, inv_root=B), v)
    return new.root, new.inv_root, new.mat


def rank1_update(L: torch.Tensor, B: torch.Tensor, A, v: torch.Tensor):
    """K4: A <- A + v v^T with the roots kept exact: p = B^T v, then
    L += c (L u) u^T and B += d (B u) u^T with u = p/|p|.

    Args:
      L, B: (Bd, m, m) root / inverse root.
      A: (Bd, m, m) Gram accumulator, or None (slim: the roots only).
      v: (Bd, m, 1) update vectors.

    Returns (L', B', A'). On CUDA, L, B and A are updated in place.
    """
    gram = {} if A is None else {"A": A}
    if _build.on_cpu(L, B, v, *gram.values()):
        return rank1_update_plain(L, B, A, v)
    _build.check_cuda_args("rank1_update_plain", L=L, B=B, v=v, **gram)
    if L.dim() != 3 or L.shape[1] != L.shape[2] or B.shape != L.shape or (A is not None and A.shape != L.shape):
        raise ValueError(f"L, B (and A) must be (Bd, m, m) of one shape; got {tuple(L.shape)}, {tuple(B.shape)}")
    Bd, m = L.shape[0], L.shape[-1]
    if tuple(v.shape) != (Bd, m, 1):
        raise ValueError(f"v must be ({Bd}, {m}, 1); got {tuple(v.shape)}")
    _build.check_grid(Bd, 2)
    lib = _root_update_lib()
    f32 = dict(dtype=torch.float32, device=L.device)
    p = torch.empty((Bd, m), **f32)
    s2 = torch.empty((Bd, lib.ogp_rank1_update_tiles(m)), **f32)
    p_ = _build.ptr
    rc = lib.ogp_rank1_update(
        p_(L), p_(B), None if A is None else p_(A), p_(v), p_(p), p_(s2), Bd, m, _build.stream_of(L),
    )
    _build.launch_check(rc, "rank1_update")
    rank1_update.launches += 1
    return L, B, A


rank1_update.launches = 0


def fused_root_cache_update(cache: RootCache, v: torch.Tensor) -> RootCache:
    """Port of ``pallas_root_cache_update``: :func:`root_cache_update`
    (A <- A + v v^T) with the q = 1 case on kernel K4.

    Routes by shape as the JAX dispatcher does: v of shape (..., m, q)
    with q != 1 goes to :func:`root_cache_update`; q = 1 goes to
    :func:`rank1_update` (K4 on CUDA, its plain version on the CPU). The
    kernel takes v of shape (Bd, m, 1) with a (Bd, m, m) cache, or (m, 1)
    with an (m, m) cache as a batch of one; where the JAX dispatcher sends
    the unbatched case to XLA, here it rides K4 too, and any other q = 1
    shape on CUDA raises. Slim caches (``mat is None``) take the
    roots-only variant. Where the JAX dispatcher sends float64 to XLA, a
    CUDA tensor that is not float32 (or requires grad, or is not
    contiguous) raises here and names ``rank1_update_plain``. On CUDA the
    cache's tensors are updated in place.
    """
    if v.shape[-1] != 1:
        return root_cache_update(cache, v)
    if v.dim() == 2:
        one = fused_root_cache_update(RootCache(*(None if t is None else t[None] for t in cache)), v[None])
        return RootCache(*(None if t is None else t[0] for t in one))
    root, inv_root, mat = rank1_update(cache.root, cache.inv_root, cache.mat, v)
    return RootCache(mat=mat, root=root, inv_root=inv_root)


# --------------------------------------------------------------------------
# K1's apply: the shape rule of its cluster kernel
# --------------------------------------------------------------------------

# What the layout of chunk_apply_cluster_kernel (csrc/root_update.cu)
# depends on: kApplyBM, kApplyStages, kApplySlot, kApplyUJ.
APPLY_TILE_ROWS = 64
APPLY_STAGES = 3
APPLY_SLOT = 64 * 32 + 32 * (128 + 4)
APPLY_UJ = 32


class ApplyPlan(NamedTuple):
    """K1's apply on clusters: ``cluster`` blocks own each ``tile_rows``-row
    tile of one X, each its ``cols`` columns, with ``shared_bytes`` of
    shared memory; ``blocks`` per output (both of L and B)."""

    cluster: int
    tile_rows: int
    cols: int
    shared_bytes: int
    blocks: int


def _chunk_apply_floats(k: int, m: int, C: int):
    """(columns per block, floats per block) of the cluster apply:
    ``chunk_apply_layout`` in ``csrc/root_update.cu``. A block's columns,
    cdiv(m, C) rounded up to 4; T (64 x k, k rounded up to 32), a C-th of
    it for its cluster sums, and the ring's three slots (64 rows of X, 32
    columns each, and those columns of A^T, rows of 128 + 4)."""
    W = 4 * -(-(-(-m // C)) // 4)  # 4 cdiv(cdiv(m, C), 4)
    t = APPLY_TILE_ROWS * APPLY_UJ * -(-k // APPLY_UJ)
    return W, t + t // C + APPLY_STAGES * APPLY_SLOT


def chunk_apply_plan(k: int, rows: int, m: int) -> Optional[ApplyPlan]:
    """The shape rule of K1's apply on ``rows`` rows of (L, B) (rows = m for
    a whole chunk) at rank k: the :class:`ApplyPlan` on clusters of 8 blocks
    when one block holds T (64 x k) with its share of the cluster sums and
    the ring in at most 232,448 bytes of shared memory (k <= 544, at any
    m; two blocks a SM up to k = 128); None where it does not, and the two
    tiled kernels run the apply. The layout does not depend on rows, the
    grid does."""
    C = _build.CLUSTER_SIZE
    W, floats = _chunk_apply_floats(k, m, C)
    if 4 * floats > MAX_SHARED_BYTES:
        return None
    return ApplyPlan(C, APPLY_TILE_ROWS, W, 4 * floats, 2 * C * -(-rows // APPLY_TILE_ROWS))


chunk_apply_plan.launches = 0
chunk_apply_plan.tiled_launches = 0
chunk_apply_plan.shapes = collections.Counter()  # (Bd, rows, m, k) -> launches


def _apply_route(lib, Bd: int, k: int, rows: int, m: int, device):
    """K1's apply at (k, rows, m) for :func:`~online_gp_torch.ops._build.route`:
    (the cluster plan, its blocks a cluster, its kernel's layout in bytes),
    or (None, 0, None) for the tiled kernels."""
    plan = chunk_apply_plan(k, rows, m)
    if plan is None:
        return None, 0, None
    return plan, plan.cluster, lib.ogp_chunk_apply_smem(k, m, plan.cluster)


def _apply_scratch(plan, Bd: int, rows: int, k: int, device):
    """T (Bd, 2, rows, k) of the tiled apply; None when the apply runs on
    clusters, which keep T in shared memory."""
    return None if plan is not None else torch.empty((Bd, 2, rows, k), dtype=torch.float32, device=device)


def _count_applies(plan, Bd: int, rows: int, m: int, k: int, n: int = 1) -> None:
    """Counts n applies launched at (Bd, rows, m, k) on the route of plan."""
    if plan is None:
        chunk_apply_plan.tiled_launches += n
    else:
        chunk_apply_plan.launches += n
    chunk_apply_plan.shapes[(Bd, rows, m, k)] += n


def _ptr_or_null(t):
    return None if t is None else _build.ptr(t)


# --------------------------------------------------------------------------
# K1 and K5: one blocked chunk of the root stream
# --------------------------------------------------------------------------


def blocked_chunk_plain(L: torch.Tensor, B: torch.Tensor, idx: torch.Tensor, wv: torch.Tensor,
                        sub=None, mode: str = "flat"):
    """Plain version of K1 (the JAX package's XLA ``chunk_step``) and K5:
    p0 = the stencil gather of B, then the factor recursion, then the
    applies. Flat (the default): :func:`blocked_factors`, L + (L R^T) U
    and B + (B P^T) U. ``sub < k``: :func:`blocked_factors_sub` and one
    such apply per sub-block, in stream order. ``mode="coord"``:
    :func:`blocked_factors_coord`, L + ((L P0^T)(Rt^T Ut)) P0 and the same
    for B with Pt. Returns new (L', B')."""
    k = idx.shape[0]
    sub = chunk_sub(k, sub, mode)
    with f32_matmul_precision():
        p0 = torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()])
        if mode == "coord":
            Ut, Pt, Rt = blocked_factors_coord(p0)
            new_L = L + ((L @ p0.mT) @ (Rt.mT @ Ut)) @ p0
            new_B = B + ((B @ p0.mT) @ (Pt.mT @ Ut)) @ p0
            return new_L, new_B
        U, Pm, R = blocked_factors(p0) if sub == k else blocked_factors_sub(p0, sub)
        for lo in range(0, k, sub):
            rows = slice(lo, lo + sub)
            L = L + (L @ R[:, rows].mT) @ U[:, rows]
            B = B + (B @ Pm[:, rows].mT) @ U[:, rows]
    return L, B


def _chunk_cluster_floats(k: int, m: int, C: int, G: int = 1, slices: int = 3):
    """(columns per block, floats per block) of the cluster recursions (K1's
    and K5 sub's) at (k, m) on G clusters of C blocks per output, with
    ``slices`` of U, P, R in shared memory (the spread kernel's 1 or 0):
    ``chunk_cluster_layout`` in ``csrc/root_update.cu``. A row pass gives
    Sr lanes to a row; the row stride ld = Sr (mod 2 Sr) keeps a warp's rows
    on distinct banks. The receive buffers are the block's own cluster's."""
    W = -(-m // (C * G))
    Sr = 1
    while Sr < 32 and 2 * Sr * k <= _build.CLUSTER_THREADS:
        Sr *= 2
    ld = W
    if Sr < 32:
        while ld % (2 * Sr) != Sr:
            ld += 1
    tiles, groups = _build.col_split(W)
    # two mbarriers; U, P, R slices (those in shared memory); p; a, g; the
    # receive buffers (two uses of C rows of k + 1); column partials; s^2
    return W, 4 + slices * k * ld + ld + 2 * k + 2 * C * (k + 1) + 2 * groups * tiles * 32 + 1


def chunk_cluster_plan(k: int, m: int):
    """The shape rule of the K1 and K5-sub recursions: the
    :class:`~online_gp_torch.ops._build.ClusterPlan` on the fewest clusters
    of 8 blocks per output, G = 1 to 8, whose blocks each hold their slices
    of U, P and R (3 k ceil(m / 8 G) floats, padded) and the step's vectors
    in at most 232,448 bytes of shared memory (at k = 128: G = 1 up to
    m = 1,120, G = 2 to 2,240, ..., 4 to 4,480, 8 to 8,960); None where
    even 8 clusters do not hold it, and the chunk then runs spread over the
    card (K1, the spread plan of rules ``K1``) or one sub-block at a time (K5
    sub, each sub-block's recursion by K1's route at k = sub). K5 sub's
    fused kernel takes the one-cluster plans (G = 1) only."""
    return _build.cluster_plan(lambda C, G: _chunk_cluster_floats(k, m, C, G),
                               clusters=range(1, _build.MAX_GRID_CLUSTERS + 1))


# K1's rules for _build.route. Past chunk_cluster_plan, or where the card
# cannot hold its G clusters at once, the spread plan on chunk_cluster_layout
# with 3, 1 or 0 slices of U, P, R in shared memory (at k = 128 on an H100
# SXM: all three up to m of about 16,800, G = 15; U alone up to about
# 50,400; then none).
K1 = _build.Rules(
    "K1", MAX_CHUNK, (3, 1, 0),
    cluster_plan=lambda k, m, P: chunk_cluster_plan(k, m),
    spread_floats=lambda k, m, P, C, G, sl: _chunk_cluster_floats(k, m, C, G, sl),
    cluster_smem=lambda lib, k, m, P, C, G: lib.ogp_chunk_cluster_smem(k, m, C, G),
    grid_capacity=lambda lib, k, m, P, C, G: lib.ogp_chunk_grid_capacity(k, m, C, G),
    spread_smem=lambda lib, k, m, P, C, G, sl: lib.ogp_chunk_spread_smem(k, m, C, G, sl),
    spread_capacity=lambda lib, k, m, P, C, G, sl: lib.ogp_chunk_spread_capacity(k, m, C, G, sl),
    apply=_apply_route,
)


def blocked_chunk(L: torch.Tensor, B: torch.Tensor, idx: torch.Tensor, wv: torch.Tensor,
                  sub=None, mode: str = "flat"):
    """K1 (and K5 for ``sub < k`` or ``mode="coord"``): k exact sequential
    rank-1 root updates with v_t = sum_p wv[b, t, p] e_{idx[t, p]}.

    Args:
      L, B: (Bd, m, m) root / inverse root.
      idx: (k, P) stencil indices in [0, m), shared by the outputs
        (int32 on CUDA).
      wv: (Bd, k, P) stencil weights already divided by sqrt(noise).
      sub: sub-block size of the two-level recursion; must divide k.
        None (or k) is the flat recursion.
      mode: "flat", or "coord" for the recursion on k-dim coordinates
        (``sub`` is then only checked).

    On CUDA the flat recursion runs on the clusters of
    :func:`chunk_cluster_plan` (one, by the carried kernel, or G > 1 in
    waves of outputs), or spread over the card past it; the sub
    recursion on the fused cluster kernel where that rule holds the chunk
    at k on one cluster, else one sub-block at a time (each by the flat
    route at k = sub). Raises ValueError for a shape no kernel takes,
    RuntimeError when a launch fails, the card cannot hold the planned
    clusters, or the plan is not the kernel's layout.

    Returns (L', B'). On CUDA, L and B are updated in place.
    """
    k = idx.shape[0]
    sub = chunk_sub(k, sub, mode)
    if _build.on_cpu(L, B, idx, wv):
        return blocked_chunk_plain(L, B, idx, wv, sub=sub, mode=mode)
    _build.check_cuda_args("blocked_chunk_plain", ints=("idx",), L=L, B=B, idx=idx, wv=wv)
    if L.dim() != 3 or L.shape[1] != L.shape[2] or B.shape != L.shape:
        raise ValueError(f"L, B must be (Bd, m, m) of one shape; got {tuple(L.shape)}, {tuple(B.shape)}")
    Bd, m = L.shape[0], L.shape[-1]
    if idx.dim() != 2 or tuple(wv.shape) != (Bd, *idx.shape):
        raise ValueError(f"idx must be (k, P) and wv (Bd, k, P); got {tuple(idx.shape)}, {tuple(wv.shape)}")
    k, P = idx.shape
    _build.check_grid(Bd, 2)
    lib = _root_update_lib()
    if mode == "coord":
        return _chunk_coord(lib, L, B, idx, wv)
    if sub < k:
        return _chunk_sub(lib, L, B, idx, wv, sub)
    dev = L.device
    r = _build.route(lib, K1, Bd, k, m, dev, rows=m)
    factors = torch.empty((4, Bd, k, m), dtype=torch.float32, device=dev)  # p0, U, P, R
    T = _apply_scratch(r.aplan, Bd, m, k, dev)
    p_ = _build.ptr
    rc = lib.ogp_blocked_chunk(
        p_(L), p_(B), p_(idx), p_(wv), p_(factors[0]), p_(factors[1]), p_(factors[2]),
        p_(factors[3]), _ptr_or_null(T), _ptr_or_null(r.slots(Bd, k, dev)), Bd, k, P, m, r.G, r.wave, r.apply,
        r.C, r.spread, _build.stream_of(L),
    )
    _build.launch_check(rc, "blocked_chunk", r.plan, r.aplan)
    blocked_chunk.launches += 1
    _build.count_recursion(blocked_chunk, r)
    _count_applies(r.aplan, Bd, m, m, k)
    return L, B


blocked_chunk.launches = 0
blocked_chunk.cluster_launches = 0
blocked_chunk.grid_cluster_launches = 0
blocked_chunk.spread_launches = 0
blocked_chunk.sub_launches = 0
blocked_chunk.sub_cluster_launches = 0
blocked_chunk.coord_launches = 0


def _chunk_sub(lib, L, B, idx, wv, sub):
    """K5 with ``sub < k``; arguments checked by :func:`blocked_chunk`. On
    the fused cluster kernel where :func:`chunk_cluster_plan` holds the
    chunk on one cluster (counted in ``blocked_chunk.sub_cluster_launches``),
    else one sub-block at a time, each sub-block's recursion by the same
    rule at k = sub."""
    Bd, m = L.shape[0], L.shape[-1]
    k, P = idx.shape
    dev = L.device
    f32 = dict(dtype=torch.float32, device=dev)
    p_ = _build.ptr
    plan = chunk_cluster_plan(k, m)
    if plan is not None and plan.clusters == 1:
        r = _build.route(lib, K1, Bd, k, m, dev, rows=m)  # the fused kernel's layout is K1's at G = 1
        factors = torch.empty((4, Bd, k, m), **f32)  # p0, U, Pc, Rc
        T = _apply_scratch(r.aplan, Bd, m, k, dev)
        rc = lib.ogp_blocked_chunk_sub_cluster(
            p_(L), p_(B), p_(idx), p_(wv), *(p_(f) for f in factors), _ptr_or_null(T), Bd, k, sub, P, m,
            r.apply, r.C, _build.stream_of(L),
        )
        _build.launch_check(rc, f"blocked_chunk (sub={sub}, k={k}, m={m})", r.plan, r.aplan)
        blocked_chunk.sub_launches += 1
        blocked_chunk.sub_cluster_launches += 1
        _count_applies(r.aplan, Bd, m, m, k)
        return L, B
    nb = k // sub
    r = _build.route(lib, K1, Bd, sub, m, dev, rows=m)
    # sub-block j's weights contiguous, as its gather reads them
    wv_sub = wv.reshape(Bd, nb, sub, P).transpose(0, 1).contiguous()
    factors = torch.empty((4, nb, Bd, sub, m), **f32)  # corrected rows q, U, P, R
    a2 = torch.empty((Bd, sub, sub), **f32)
    T = _apply_scratch(r.aplan, Bd, m, sub, dev)
    rc = lib.ogp_blocked_chunk_sub(
        p_(L), p_(B), p_(idx), p_(wv_sub), p_(factors[0]), p_(factors[1]), p_(factors[2]),
        p_(factors[3]), p_(a2), _ptr_or_null(T), _ptr_or_null(r.slots(Bd, sub, dev, nb)), Bd, k, sub, P, m, r.G,
        r.wave, r.apply, r.C, r.spread, _build.stream_of(L),
    )
    _build.launch_check(rc, "blocked_chunk (sub)", r.plan, r.aplan)
    blocked_chunk.sub_launches += 1
    _count_applies(r.aplan, Bd, m, m, sub, nb)
    return L, B


def _chunk_coord(lib, L, B, idx, wv):
    """K5 with ``mode="coord"``; arguments checked by :func:`blocked_chunk`."""
    Bd, m = L.shape[0], L.shape[-1]
    k, P = idx.shape
    if lib.ogp_blocked_chunk_coord_smem(k) > MAX_SHARED_BYTES:
        raise ValueError(f"chunk (k={k}) exceeds what the coord kernel takes "
                         f"((3k^2 + 3k + 32) floats of shared memory <= {MAX_SHARED_BYTES} bytes)")
    f32 = dict(dtype=torch.float32, device=L.device)
    p0 = torch.empty((Bd, k, m), **f32)
    M = torch.empty((Bd, lib.ogp_blocked_chunk_coord_splits(), k, k), **f32)  # partials of P0 P0^T
    F = torch.empty((3, Bd, k, k), **f32)  # Ut, Rt, Pt
    X = torch.empty((3, Bd, k, m), **f32)  # U, R, P = F P0
    r = _build.route(lib, K1, Bd, k, m, L.device, rows=m, recursion=False)
    T = _apply_scratch(r.aplan, Bd, m, k, L.device)
    p_ = _build.ptr
    rc = lib.ogp_blocked_chunk_coord(
        p_(L), p_(B), p_(idx), p_(wv), p_(p0), p_(M), p_(F), p_(X), _ptr_or_null(T), Bd, k, P, m, r.apply,
        _build.stream_of(L),
    )
    _build.launch_check(rc, "blocked_chunk (coord)", r.aplan)
    blocked_chunk.coord_launches += 1
    _count_applies(r.aplan, Bd, m, m, k)
    return L, B


# --------------------------------------------------------------------------
# K1's stages on row shards
# --------------------------------------------------------------------------


def shard_stencil(idx: torch.Tensor, w: torch.Tensor, row0: int, rows: int):
    """A stencil's entries as seen by the shard of rows [row0, row0 + rows):
    indices shifted by -row0 (int64) and clamped into the shard, weights
    zeroed outside it, so a densified row has the shard's columns only
    (the JAX package's ``stencil_rows(idx - row0, ...)``, whose scatter
    drops the entries outside)."""
    loc = idx.long() - row0
    inside = (loc >= 0) & (loc < rows)
    return loc.clamp(0, rows - 1), torch.where(inside, w, torch.zeros_like(w))


def chunk_gather_rows_plain(B: torch.Tensor, idx: torch.Tensor, wv: torch.Tensor, row0: int):
    """Plain version of :func:`chunk_gather_rows`: the shard's densified
    stencil rows S[:, rows] times its rows of B, (Bd, k, rows) @ (Bd, rows, m)."""
    Bd, rows, _ = B.shape
    loc, wl = shard_stencil(idx, wv, row0, rows)
    S = B.new_zeros((Bd, *idx.shape[:1], rows)).scatter_add(2, loc.expand(wl.shape), wl)
    with f32_matmul_precision():
        return S @ B


def chunk_gather_rows(B: torch.Tensor, idx: torch.Tensor, wv: torch.Tensor, row0: int) -> torch.Tensor:
    """K1's gather on a row shard: p0_part[b, t] = sum_p wv[b, t, p]
    B[b, idx[t, p] - row0] over the stencil points in [row0, row0 + rows).

    Args:
      B: (Bd, rows, m) rows [row0, row0 + rows) of the inverse roots.
      idx: (k, P) stencil indices in [0, m) (int32 on CUDA); wv: (Bd, k, P)
        weights over sqrt(noise).
      row0: the shard's first row.

    Returns the (Bd, k, m) partial p0; the shards' partials sum to the
    chunk's p0.
    """
    if _build.on_cpu(B, idx, wv):
        return chunk_gather_rows_plain(B, idx, wv, row0)
    _build.check_cuda_args("chunk_gather_rows_plain", ints=("idx",), B=B, idx=idx, wv=wv)
    if B.dim() != 3 or idx.dim() != 2 or tuple(wv.shape) != (B.shape[0], *idx.shape):
        raise ValueError(f"B must be (Bd, rows, m), idx (k, P) and wv (Bd, k, P); got {tuple(B.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(wv.shape)}")
    Bd, rows, m = B.shape
    k, P = idx.shape
    _build.check_grid(Bd, 2)
    p0 = torch.empty((Bd, k, m), dtype=torch.float32, device=B.device)
    p_ = _build.ptr
    rc = _root_update_lib().ogp_chunk_gather_rows(p_(B), p_(idx), p_(wv), p_(p0), Bd, k, P, rows, m, int(row0),
                                                  _build.stream_of(B))
    _build.launch_check(rc, "chunk_gather_rows")
    chunk_gather_rows.launches += 1
    return p0


chunk_gather_rows.launches = 0


def chunk_factors_plain(p0: torch.Tensor):
    """Plain version of :func:`chunk_factors`: :func:`blocked_factors`."""
    return blocked_factors(p0)


def chunk_factors(p0: torch.Tensor):
    """K1's recursion on a chunk's summed p0 (Bd, k, m): returns (U, P, R),
    each (Bd, k, m), on the clusters of :func:`chunk_cluster_plan` where it
    holds the chunk (counted in ``cluster_launches``, those on G > 1
    clusters also in ``grid_cluster_launches``), else spread over the card
    (counted in ``spread_launches``)."""
    if _build.on_cpu(p0):
        return chunk_factors_plain(p0)
    _build.check_cuda_args("chunk_factors_plain", p0=p0)
    if p0.dim() != 3:
        raise ValueError(f"p0 must be (Bd, k, m); got {tuple(p0.shape)}")
    Bd, k, m = p0.shape
    _build.check_grid(Bd, 2)
    lib = _root_update_lib()
    r = _build.route(lib, K1, Bd, k, m, p0.device)
    U, Pm, R = torch.empty((3, Bd, k, m), dtype=torch.float32, device=p0.device)
    p_ = _build.ptr
    rc = lib.ogp_chunk_factors(p_(p0), p_(U), p_(Pm), p_(R), _ptr_or_null(r.slots(Bd, k, p0.device)), Bd, k, m,
                               r.G, r.wave, r.C, r.spread, _build.stream_of(p0))
    _build.launch_check(rc, "chunk_factors", r.plan)
    chunk_factors.launches += 1
    _build.count_recursion(chunk_factors, r)
    return U, Pm, R


chunk_factors.launches = 0
chunk_factors.cluster_launches = 0
chunk_factors.grid_cluster_launches = 0
chunk_factors.spread_launches = 0


def chunk_apply_rows_plain(L: torch.Tensor, B: torch.Tensor, U: torch.Tensor, Pm: torch.Tensor, R: torch.Tensor):
    """Plain version of :func:`chunk_apply_rows`; returns new (L', B')."""
    with f32_matmul_precision():
        return L + (L @ R.mT) @ U, B + (B @ Pm.mT) @ U


def chunk_apply_rows(L: torch.Tensor, B: torch.Tensor, U: torch.Tensor, Pm: torch.Tensor, R: torch.Tensor):
    """K1's apply on a row shard: L += (L R^T) U, B += (B P^T) U, on
    clusters where :func:`chunk_apply_plan` holds (k, rows, m), else on the
    tiled kernels. At rows = m it is the whole chunk's apply.

    Args:
      L, B: (Bd, rows, m) a shard's rows of the root and inverse root.
      U, Pm, R: (Bd, k, m) the chunk's factors (:func:`chunk_factors`).

    Returns (L', B'). On CUDA, L and B are updated in place.
    """
    if _build.on_cpu(L, B, U, Pm, R):
        return chunk_apply_rows_plain(L, B, U, Pm, R)
    _build.check_cuda_args("chunk_apply_rows_plain", L=L, B=B, U=U, Pm=Pm, R=R)
    if L.dim() != 3 or B.shape != L.shape or U.dim() != 3 or not (U.shape == Pm.shape == R.shape) \
            or U.shape[0] != L.shape[0] or U.shape[2] != L.shape[2]:
        raise ValueError(f"L, B must be (Bd, rows, m) and U, Pm, R (Bd, k, m); got {tuple(L.shape)}, "
                         f"{tuple(B.shape)}, {tuple(U.shape)}, {tuple(Pm.shape)}, {tuple(R.shape)}")
    Bd, rows, m = L.shape
    k = U.shape[1]
    _build.check_grid(Bd, 2)
    lib = _root_update_lib()
    r = _build.route(lib, K1, Bd, k, m, L.device, rows=rows, recursion=False)
    T = _apply_scratch(r.aplan, Bd, rows, k, L.device)
    p_ = _build.ptr
    rc = lib.ogp_chunk_apply_rows(p_(L), p_(B), p_(R), p_(Pm), p_(U), _ptr_or_null(T), Bd, k, rows, m, r.apply,
                                  _build.stream_of(L))
    _build.launch_check(rc, "chunk_apply_rows", r.aplan)
    chunk_apply_rows.launches += 1
    _count_applies(r.aplan, Bd, rows, m, k)
    return L, B


chunk_apply_rows.launches = 0
