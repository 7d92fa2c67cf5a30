"""Kernel K3 (``pred_chunk``): one predict-then-condition chunk on the
card, beside its plain PyTorch version.

K3 replaces ``pallas_pred_chunk`` and ``pallas_pred_chunk_batched``
(``online_gp_tpu/ops/pallas_pred_stream.py``), one kernel for both: the
stencil is shared by the outputs and the caches carry a leading batch
dim (Bd = 1 for a single output). The CUDA source, with the design notes,
is ``online_gp_torch/csrc/pred_stream.cu``. The caches are not padded to
a lane-tile multiple: the kernel masks its own ragged edge.

The recursion runs on a thread-block cluster: :func:`pred_cluster_plan`
splits each output's m columns over 8 blocks that keep their columns of
Z in shared memory, or over 16 (a non-portable cluster size) where 8
blocks cannot hold them (m > 3,136 at k = 128 with a 2-D cubic stencil,
P = 16). A chunk whose slices 16 blocks cannot hold either (m > 6,016 at
k = 128, P = 16, or k > 342 at m = 900) runs spread over the card
(``pred_recursion_spread_kernel``, the spread plan of rules ``K3``): as many
clusters of 8 as the card holds at once, up to 16, whose sums meet in
device memory, each block keeping its slice of Z in shared memory where
it fits, else in the output Z. The rule is by shape and the card's
capacity: nothing is tried and caught, and every k <= 1,024 and every m
the card's memory holds has a kernel.
:func:`~online_gp_torch.ops._build.route` decides each shape's route once,
on rules ``K3``, checking each plan's shared memory against the kernel's
layout (``ogp_pred_cluster_smem``, ``ogp_pred_spread_smem``,
``ogp_pred_apply_smem``) before the first launch and raising RuntimeError
if they differ.

Dispatch, by the tensors given: on the CPU the plain version runs; on
CUDA with float32 (int32 indices) the kernel launches; anything else
raises TypeError and names the plain version. The kernels take 64-bit
element offsets, so no size of the caches is refused; a batch past the
launch grid raises ValueError; a failed launch, or a cluster the card
cannot schedule, raises RuntimeError. On CUDA the caches are updated in
place. ``pred_chunk.launches`` counts the calls that launched the kernel,
``pred_chunk.cluster_launches`` those whose recursion ran on a cluster,
``pred_chunk.wide_cluster_launches`` those of them on 16 blocks, and
``pred_chunk.spread_launches`` those spread over the card.

K3's apply (C -= Z^T Z, mu += Z^T r), which ends :func:`pred_chunk` and
is :func:`pred_apply_rows`, runs 128 x 128 tiles of C a block, or 64 x
128 where those would leave SMs without a block (:func:`pred_apply_plan`,
by shape and the card's SM count). Every apply launched adds
one to ``pred_apply_plan.launches`` and to
``pred_apply_plan.shapes[(Bd, rows, m, k)]``.

K3's three stages are also wrappers of their own, for caches whose rows
are sharded over processes (``parallel/mesh.py::sharded_pred_stream_blocked``):
:func:`pred_gather_rows` (the partial c0w and mu0w of a shard's rows),
:func:`pred_factors` (the recursion on the summed partials) and
:func:`pred_apply_rows` (the apply on a shard's rows), each beside its plain
version and counting its own ``launches`` (``pred_factors`` also
``cluster_launches``, ``wide_cluster_launches`` and ``spread_launches``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from online_gp_torch.ops import _build
from online_gp_torch.ops.cuda_root_update import _ptr_or_null, shard_stencil
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.pred_stream import pred_chunk_factors, pred_chunk_plain
from online_gp_torch.ops.root_update import stencil_rows

# What the spread recursion takes past pred_cluster_plan: k <= MAX_CHUNK.
MAX_CHUNK = 1024
MAX_SHARED_BYTES = _build.MAX_SHARED_BYTES

_lib = None


def _pred_stream_lib():
    global _lib
    if _lib is None:
        lib = _build.load("pred_stream")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ogp_pred_chunk.argtypes = [vp] * 13 + [i32] * 9 + [vp]
        lib.ogp_pred_chunk.restype = i32
        lib.ogp_pred_cluster_smem.argtypes = [i32] * 4
        lib.ogp_pred_cluster_smem.restype = ctypes.c_longlong
        lib.ogp_pred_cluster_capacity.argtypes = [i32] * 4
        lib.ogp_pred_cluster_capacity.restype = i32
        lib.ogp_pred_spread_smem.argtypes = [i32] * 6
        lib.ogp_pred_spread_smem.restype = ctypes.c_longlong
        lib.ogp_pred_spread_capacity.argtypes = [i32] * 6
        lib.ogp_pred_spread_capacity.restype = i32
        lib.ogp_pred_gather_rows.argtypes = [vp] * 6 + [i32] * 6 + [vp]
        lib.ogp_pred_gather_rows.restype = i32
        lib.ogp_pred_factors.argtypes = [vp] * 11 + [i32] * 8 + [vp]
        lib.ogp_pred_factors.restype = i32
        lib.ogp_pred_apply_rows.argtypes = [vp] * 4 + [i32] * 6 + [vp]
        lib.ogp_pred_apply_rows.restype = i32
        lib.ogp_pred_apply_smem.argtypes = [i32]
        lib.ogp_pred_apply_smem.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def pred_chunk_stencil_plain(C, mu, idx, wv, y, nz):
    """Plain version of K3: :func:`pred_chunk_plain` on the densified
    stencil rows. Returns new (C', mu', pred_mean, pred_var)."""
    return pred_chunk_plain(C, mu, stencil_rows(idx, wv, C.shape[-1]), y, nz)


def _pred_cluster_floats(k: int, m: int, P: int, C: int, G: int = 1, slices: int = 2):
    """(columns per block, floats per block) of the cluster recursion on G
    clusters of C blocks per output with ``slices`` in shared memory: 2,
    the block's slice of Z and its stencil entries; the spread kernel's 1,
    the stencil entries alone, or 0, neither: ``pred_cluster_layout`` in
    ``csrc/pred_stream.cu``."""
    W = -(-m // (C * G))
    tiles, groups = _build.col_split(W)
    # two mbarriers; Z slice; ct; a (two steps); the receive buffers (two
    # uses of C rows of k + 1); r, mu0w, y, nz; column partials; the chunk's
    # stencil entries in this block (local columns, weights, counts); inv, r . a
    return W, (4 + (k * W if slices == 2 else 0) + W + 2 * k + 2 * C * (k + 1) + 4 * k + groups * tiles * 32
               + (2 * k * P + k if slices >= 1 else 0) + 2)


def pred_cluster_plan(k: int, m: int, P: int):
    """The shape rule of K3's recursion: the :class:`~online_gp_torch.ops._build.ClusterPlan`
    on one cluster of 8 blocks, when each block holds its slice of Z
    (k ceil(m / 8) floats), the chunk's stencil and the step's vectors in
    at most 232,448 bytes of shared memory, else on one cluster of 16
    blocks (k ceil(m / 16) floats) when that holds them; None where neither
    does, and the chunk then runs spread over the card."""
    return _build.cluster_plan(lambda C, G: _pred_cluster_floats(k, m, P, C),
                               sizes=(_build.CLUSTER_SIZE, _build.WIDE_CLUSTER_SIZE))


# What the layout of pred_apply_kernel (csrc/pred_stream.cu) depends on:
# kPredBN, kPredKT, kPredStages.
PRED_APPLY_COLS = 128
PRED_APPLY_DEPTH = 16
PRED_APPLY_STAGES = 3


class PredApplyPlan(NamedTuple):
    """K3's apply: tiles of ``tile_rows`` x ``tile_cols`` of C a block, with
    ``shared_bytes`` of shared memory; ``blocks`` in all."""

    tile_rows: int
    tile_cols: int
    shared_bytes: int
    blocks: int


def pred_apply_plan(Bd: int, rows: int, m: int, sms: int) -> PredApplyPlan:
    """The tile rule of K3's apply on ``rows`` rows of Bd caches of width m
    on a card of ``sms`` SMs (:func:`~online_gp_torch.ops._build.card_sms`):
    128-row tiles where they give every SM a block, else 64-row tiles (an
    H100 SXM's 132 SMs at m = 900: 120 blocks of 64 rows against 64 of
    128). The ring's three slots of 16 rows of Z, for the tile's rows and
    its 128 columns, are its shared memory."""
    blocks = lambda bm: Bd * -(-rows // bm) * -(-m // PRED_APPLY_COLS)
    bm = 128 if blocks(128) >= sms else 64
    nbytes = 4 * PRED_APPLY_STAGES * PRED_APPLY_DEPTH * (bm + PRED_APPLY_COLS)
    return PredApplyPlan(bm, PRED_APPLY_COLS, nbytes, blocks(bm))


pred_apply_plan.launches = 0
pred_apply_plan.shapes = collections.Counter()  # (Bd, rows, m, k) -> launches


def _apply_route(lib, Bd: int, k: int, rows: int, m: int, device):
    """K3's apply on ``rows`` rows of Bd caches of width m, on the card of
    ``device``, for :func:`~online_gp_torch.ops._build.route`: (its plan,
    its tile rows, its kernel's layout in bytes)."""
    plan = pred_apply_plan(Bd, rows, m, _build.card_sms(device))
    return plan, plan.tile_rows, lib.ogp_pred_apply_smem(plan.tile_rows)


# K3's rules for _build.route. Past pred_cluster_plan, the spread plan on
# pred_cluster_layout with the block's slice of Z and its stencil entries in
# shared memory (2), the stencil entries alone (1, Z in device memory) or
# neither (0, every k <= 1,024 at every P).
K3 = _build.Rules(
    "K3", MAX_CHUNK, (2, 1, 0),
    cluster_plan=pred_cluster_plan,
    spread_floats=_pred_cluster_floats,
    cluster_smem=lambda lib, k, m, P, C, G: lib.ogp_pred_cluster_smem(k, m, P, C),
    grid_capacity=None,  # K3's cluster plans are one cluster an output
    spread_smem=lambda lib, k, m, P, C, G, sl: lib.ogp_pred_spread_smem(k, m, P, C, G, sl),
    spread_capacity=lambda lib, k, m, P, C, G, sl: lib.ogp_pred_spread_capacity(k, m, P, C, G, sl),
    apply=_apply_route,
)


def _count_apply(Bd: int, rows: int, m: int, k: int) -> None:
    pred_apply_plan.launches += 1
    pred_apply_plan.shapes[(Bd, rows, m, k)] += 1


def _check_stencil_args(idx, wv, Bd, k_vectors):
    """Raise ValueError unless idx, wv are (k, P), each of ``k_vectors``
    (Bd, k), and Bd fits the launch grid."""
    if idx.dim() != 2 or wv.shape != idx.shape:
        raise ValueError(f"idx and wv must be (k, P); got {tuple(idx.shape)}, {tuple(wv.shape)}")
    k = idx.shape[0]
    for name, t in k_vectors.items():
        if tuple(t.shape) != (Bd, k):
            raise ValueError(f"{name} must be ({Bd}, {k}); got {tuple(t.shape)}")
    _build.check_grid(Bd)


def pred_chunk(C, mu, idx, wv, y, nz):
    """K3: one rank-k predict-then-condition chunk, batched over outputs.

    Args:
      C: (Bd, m, m) covariance caches; mu: (Bd, m) mean caches.
      idx: (k, P) stencil indices in [0, m) (int32 on CUDA); wv: (k, P)
        stencil weights (not noise-scaled); both shared by the outputs.
      y, nz: (Bd, k) targets and clamped noise.

    On CUDA the recursion runs on a cluster of :func:`pred_cluster_plan`
    (8 or 16 blocks), or spread over the card where that returns None.
    Raises ValueError for a shape no kernel takes, RuntimeError when a
    launch fails, the card cannot hold the planned clusters, or the plan
    is not the kernel's layout.

    Returns (C', mu', pred_mean (Bd, k), pred_var (Bd, k)). On CUDA, C and
    mu are updated in place.
    """
    if _build.on_cpu(C, mu, idx, wv, y, nz):
        return pred_chunk_stencil_plain(C, mu, idx, wv, y, nz)
    _build.check_cuda_args(
        "pred_chunk_stencil_plain", ints=("idx",), C=C, mu=mu, idx=idx, wv=wv, y=y, nz=nz
    )
    if C.dim() != 3 or C.shape[1] != C.shape[2]:
        raise ValueError(f"C must be (Bd, m, m); got {tuple(C.shape)}")
    Bd, m = C.shape[0], C.shape[-1]
    if tuple(mu.shape) != (Bd, m):
        raise ValueError(f"mu must be ({Bd}, {m}); got {tuple(mu.shape)}")
    _check_stencil_args(idx, wv, Bd, dict(y=y, nz=nz))
    k, P = idx.shape
    lib = _pred_stream_lib()
    dev = C.device
    r = _build.route(lib, K3, Bd, k, m, dev, P, rows=m)
    f32 = dict(dtype=torch.float32, device=dev)
    c0w = torch.empty((Bd, k, m), **f32)
    Z = torch.empty((Bd, k, m), **f32)
    vecs = torch.empty((4, Bd, k), **f32)  # mu0w, r, pred_mean, pred_var
    p_ = _build.ptr
    rc = lib.ogp_pred_chunk(
        p_(C), p_(mu), p_(idx), p_(wv), p_(y), p_(nz), p_(c0w), p_(vecs[0]), p_(Z),
        p_(vecs[1]), p_(vecs[2]), p_(vecs[3]), _ptr_or_null(r.slots(Bd, k, dev)), Bd, k, P, m, r.apply, r.C,
        r.G, r.wave, r.spread, _build.stream_of(C),
    )
    _build.launch_check(rc, "pred_chunk", r.plan)
    pred_chunk.launches += 1
    _build.count_recursion(pred_chunk, r)
    _count_apply(Bd, m, m, k)
    return C, mu, vecs[2], vecs[3]


pred_chunk.launches = 0
pred_chunk.cluster_launches = 0
pred_chunk.wide_cluster_launches = 0
pred_chunk.spread_launches = 0


# --------------------------------------------------------------------------
# K3's stages on row shards
# --------------------------------------------------------------------------


def pred_gather_rows_plain(C, mu, idx, wv, row0: int):
    """Plain version of :func:`pred_gather_rows`: the shard's densified
    stencil rows S[:, rows] times its rows of C and mu."""
    rows = C.shape[-2]
    loc, wl = shard_stencil(idx, wv, row0, rows)
    S = stencil_rows(loc, wl, rows)  # (k, rows)
    with f32_matmul_precision():
        return S @ C, mu @ S.mT


def pred_gather_rows(C, mu, idx, wv, row0: int):
    """K3's gather on a row shard: the partials c0w[b, t] = sum_p wv[t, p]
    C[b, idx[t, p] - row0] and mu0w[b, t] = sum_p wv[t, p] mu[b, idx[t, p] - row0]
    over the stencil points in [row0, row0 + rows).

    Args:
      C: (Bd, rows, m) rows [row0, row0 + rows) of the covariance caches;
        mu: (Bd, rows) those entries of the mean caches.
      idx, wv: (k, P) the chunk's stencil (int32 indices in [0, m) on
        CUDA; weights not noise-scaled), shared by the outputs.

    Returns (c0w (Bd, k, m), mu0w (Bd, k)); the shards' partials sum to the
    chunk's.
    """
    if _build.on_cpu(C, mu, idx, wv):
        return pred_gather_rows_plain(C, mu, idx, wv, row0)
    _build.check_cuda_args("pred_gather_rows_plain", ints=("idx",), C=C, mu=mu, idx=idx, wv=wv)
    if C.dim() != 3 or tuple(mu.shape) != tuple(C.shape[:2]):
        raise ValueError(f"C must be (Bd, rows, m) and mu (Bd, rows); got {tuple(C.shape)}, {tuple(mu.shape)}")
    Bd, rows, m = C.shape
    _check_stencil_args(idx, wv, Bd, {})
    k, P = idx.shape
    f32 = dict(dtype=torch.float32, device=C.device)
    c0w, mu0w = torch.empty((Bd, k, m), **f32), torch.empty((Bd, k), **f32)
    p_ = _build.ptr
    rc = _pred_stream_lib().ogp_pred_gather_rows(p_(C), p_(mu), p_(idx), p_(wv), p_(c0w), p_(mu0w), Bd, k, P,
                                                 rows, m, int(row0), _build.stream_of(C))
    _build.launch_check(rc, "pred_gather_rows")
    pred_gather_rows.launches += 1
    return c0w, mu0w


pred_gather_rows.launches = 0


def pred_factors_plain(idx, wv, c0w, mu0w, y, nz):
    """Plain version of :func:`pred_factors`: :func:`pred_chunk_factors` on
    the densified stencil rows."""
    return pred_chunk_factors(stencil_rows(idx, wv, c0w.shape[-1]), c0w, mu0w, y, nz)


def pred_factors(idx, wv, c0w, mu0w, y, nz):
    """K3's recursion on a chunk's summed c0w (Bd, k, m) and mu0w (Bd, k),
    with its stencil idx, wv (k, P) and targets and clamped noise y, nz
    (Bd, k): returns (Z (Bd, k, m), r, pred_mean, pred_var (Bd, k)), on
    clusters where :func:`pred_cluster_plan` holds the chunk, else spread
    over the card."""
    if _build.on_cpu(idx, wv, c0w, mu0w, y, nz):
        return pred_factors_plain(idx, wv, c0w, mu0w, y, nz)
    _build.check_cuda_args("pred_factors_plain", ints=("idx",), idx=idx, wv=wv, c0w=c0w, mu0w=mu0w, y=y, nz=nz)
    if c0w.dim() != 3 or tuple(c0w.shape[1:2]) != tuple(idx.shape[:1]):
        raise ValueError(f"c0w must be (Bd, k, m) for idx (k, P); got {tuple(c0w.shape)}, {tuple(idx.shape)}")
    Bd, k, m = c0w.shape
    _check_stencil_args(idx, wv, Bd, dict(mu0w=mu0w, y=y, nz=nz))
    P = idx.shape[1]
    lib = _pred_stream_lib()
    dev = c0w.device
    r = _build.route(lib, K3, Bd, k, m, dev, P)
    f32 = dict(dtype=torch.float32, device=dev)
    Z = torch.empty((Bd, k, m), **f32)
    vecs = torch.empty((3, Bd, k), **f32)  # r, pred_mean, pred_var
    p_ = _build.ptr
    rc = lib.ogp_pred_factors(p_(idx), p_(wv), p_(c0w), p_(mu0w), p_(y), p_(nz), p_(Z), p_(vecs[0]),
                              p_(vecs[1]), p_(vecs[2]), _ptr_or_null(r.slots(Bd, k, dev)), Bd, k, P, m, r.C, r.G,
                              r.wave, r.spread, _build.stream_of(c0w))
    _build.launch_check(rc, "pred_factors", r.plan)
    pred_factors.launches += 1
    _build.count_recursion(pred_factors, r)
    return Z, vecs[0], vecs[1], vecs[2]


pred_factors.launches = 0
pred_factors.cluster_launches = 0
pred_factors.wide_cluster_launches = 0
pred_factors.spread_launches = 0


def pred_apply_rows_plain(C, mu, Z, r, row0: int):
    """Plain version of :func:`pred_apply_rows`; returns new (C', mu')."""
    Z_loc = Z[..., row0 : row0 + C.shape[-2]]
    with f32_matmul_precision():
        return C - Z_loc.mT @ Z, mu + (Z_loc.mT @ r[..., None])[..., 0]


def pred_apply_rows(C, mu, Z, r, row0: int):
    """K3's apply on a row shard: C -= Z[:, rows]^T Z and mu += Z[:, rows]^T r
    for the shard's rows [row0, row0 + rows).

    Args:
      C: (Bd, rows, m); mu: (Bd, rows); Z: (Bd, k, m); r: (Bd, k).

    Returns (C', mu'). On CUDA, C and mu are updated in place.
    """
    if _build.on_cpu(C, mu, Z, r):
        return pred_apply_rows_plain(C, mu, Z, r, row0)
    _build.check_cuda_args("pred_apply_rows_plain", C=C, mu=mu, Z=Z, r=r)
    if C.dim() != 3 or tuple(mu.shape) != tuple(C.shape[:2]) or Z.dim() != 3 or Z.shape[0] != C.shape[0] \
            or Z.shape[2] != C.shape[2] or tuple(r.shape) != tuple(Z.shape[:2]):
        raise ValueError(f"C must be (Bd, rows, m), mu (Bd, rows), Z (Bd, k, m) and r (Bd, k); got "
                         f"{tuple(C.shape)}, {tuple(mu.shape)}, {tuple(Z.shape)}, {tuple(r.shape)}")
    Bd, rows, m = C.shape
    if not 0 <= row0 <= m - rows:
        raise ValueError(f"rows [{row0}, {row0 + rows}) do not lie in [0, {m})")
    k = Z.shape[1]
    _build.check_grid(Bd)
    lib = _pred_stream_lib()
    AM = _build.route(lib, K3, Bd, k, m, C.device, rows=rows, recursion=False).apply
    p_ = _build.ptr
    rc = lib.ogp_pred_apply_rows(p_(C), p_(mu), p_(Z), p_(r), Bd, k, rows, m, int(row0), AM, _build.stream_of(C))
    _build.launch_check(rc, "pred_apply_rows")
    pred_apply_rows.launches += 1
    _count_apply(Bd, rows, m, k)
    return C, mu


pred_apply_rows.launches = 0
