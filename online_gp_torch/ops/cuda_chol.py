"""Kernel K6 (``blocked_cholesky``): a blocked Cholesky on the card,
beside its plain PyTorch version.

K6 replaces ``blocked_cholesky`` (``online_gp_tpu/ops/pallas_chol.py``):
the lower Cholesky factor of an SPD matrix by a right-looking blocked
algorithm with panels of 128 columns. On the card each panel is three
kernels: the diagonal tile factored by one block in inner panels of 32
columns (one warp each, which also inverts its 32 x 32 block), the solve
of the rows below, and the trailing update over the lower tiles only. The CUDA
source, with the design notes, is ``online_gp_torch/csrc/chol.cu``.

:func:`cholesky_plan` is the shape rule of the trailing update: per panel,
the tile (32, 64 or 128 a side) and, with look-ahead, the split of the
update into the next panel's column block and the rest. The wrapper hands
the plan to the C entry, which refuses a plan that is not its layout. Every
tile gives the same bits: each element sums its panel's products in the same
order.

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
import functools
from typing import NamedTuple, Tuple

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
# Look-ahead over the panel chain where the plan takes it (wide batches,
# LOOKAHEAD_MIN_BD_M): the next panel's factor and solve overlap the rest of
# this panel's trailing update. chip_smoke.py times K6 with it on and off.
LOOKAHEAD = True

# The trailing update's tiles, each with its kernel (csrc/chol.cu): the
# 32 x 32 kernel, which holds two 32-row strips of the panel (row stride
# 129), and chol_trail_kernel<T>, whose TRAIL_STAGES buffers each hold a
# slice of TRAIL_K panel columns of two T-row strips.
TRAIL_KERNELS = {32: "chol_syrk_kernel", 64: "chol_trail_kernel<64>", 128: "chol_trail_kernel<128>"}
TRAIL_K = 16  # kTrailK
TRAIL_STAGES = 2  # kTrailStages
# A trailing-update launch at tile T takes about a + b w microseconds on an
# H100 SXM (132 SMs, 700 W), w = cdiv(blocks, SMs) its blocks a SM: (a, b)
# fitted to each panel's launch time of scripts/probe_chol_tiles.py
# (T = 128 runs two blocks a SM, 64 three, 32 up to eight).
TRAIL_COST_US = {32: (2.42, 2.56), 64: (2.97, 5.03), 128: (3.31, 15.2)}
# Look-ahead pays where the rest of a panel's update is large beside the
# factor and the solve, from Bd m = LOOKAHEAD_MIN_BD_M on: at (Bd, m) =
# (1, 4,096) 1.765 against 1.946 ms, (2, 1,936) 0.716 against 0.730; not at
# (1, 1,936), 0.595 against 0.586 (probe_chol_tiles.py, part (b)), nor at
# (1, 2,048), 0.652 against 0.631 (chip_smoke.py's check_k6).
LOOKAHEAD_MIN_BD_M = 3072
BAD_PLAN = -2  # kBadPlan: the C entry refused the plan

_lib = None


def _chol_lib():
    global _lib
    if _lib is None:
        lib = _build.load("chol")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ogp_blocked_cholesky.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp, vp, i32, vp]
        lib.ogp_blocked_cholesky.restype = i32
        lib.ogp_chol_trail_smem.argtypes = [i32]
        lib.ogp_chol_trail_smem.restype = i32
        _lib = lib
    return _lib


class PanelPlan(NamedTuple):
    """The trailing update of the panel at column ``lo``: the trailing
    matrix is n x n (n = m - lo - 128). ``tile``: the side of its tiles
    (of the rest's, under look-ahead); ``blocks``: that launch's blocks a
    matrix (0: no launch). Under look-ahead ``next_tile`` and
    ``next_blocks`` are the next panel's column block's launch, whose grid
    also holds the blocks above the diagonal that own no tile; else 0."""

    lo: int
    n: int
    tile: int
    blocks: int
    next_tile: int = 0
    next_blocks: int = 0


class CholPlan(NamedTuple):
    """K6's launches for (Bd, m, m): one PanelPlan for each panel with a
    trailing matrix, and whether the chain runs with look-ahead."""

    m: int
    Bd: int
    lookahead: bool
    panels: Tuple[PanelPlan, ...]


def lower_tiles(n: int, tile: int) -> int:
    """Tiles of ``tile`` a side on and below the diagonal of an n x n matrix."""
    t = -(-n // tile)
    return t * (t + 1) // 2


def trail_cost(blocks: int, tile: int, sms: int) -> float:
    """The modelled microseconds of a trailing-update launch of ``blocks``
    blocks at ``tile`` on a card of ``sms`` SMs (TRAIL_COST_US)."""
    a, b = TRAIL_COST_US[tile]
    return a + b * -(-blocks // sms)


def trail_tile(n: int, Bd: int, sms: int) -> int:
    """The trailing update's tile at width n: the one whose launch over the
    lower tiles of the Bd matrices costs least (:func:`trail_cost`)."""
    return min(TRAIL_KERNELS, key=lambda tile: trail_cost(Bd * lower_tiles(n, tile), tile, sms))


def next_tile(n: int, Bd: int, sms: int) -> int:
    """Under look-ahead, the tile of the next panel's column block (n rows of
    KERNEL_BLOCK columns): 32 or 64, whichever launch costs less."""
    return min((32, 64), key=lambda tile: trail_cost(Bd * -(-n // tile) * (KERNEL_BLOCK // tile), tile, sms))


def trail_smem_bytes(tile: int) -> int:
    """Shared memory of a block of the trailing update's kernel at ``tile``,
    as ``ogp_chol_trail_smem``."""
    return 4 * 2 * 32 * (KERNEL_BLOCK + 1) if tile == 32 else 4 * TRAIL_STAGES * 2 * TRAIL_K * tile


def cholesky_plan(m: int, Bd: int, sms: int, lookahead: bool = None) -> CholPlan:
    """The shape rule of K6's trailing updates for (Bd, m, m) on a card of
    ``sms`` SMs: each panel's tile by :func:`trail_tile`. Look-ahead
    (``LOOKAHEAD`` by default) is taken from Bd m = LOOKAHEAD_MIN_BD_M on: then
    each panel's update splits into the next panel's 128 columns, on the
    tile of :func:`next_tile`, and the rest, the lower triangle past those
    columns. Plans are kept by shape (tens to hundreds of microseconds of
    host time each)."""
    lookahead = bool(LOOKAHEAD if lookahead is None else lookahead) and Bd * m >= LOOKAHEAD_MIN_BD_M
    return _cholesky_plan(m, Bd, sms, lookahead)


@functools.lru_cache(maxsize=256)
def _cholesky_plan(m: int, Bd: int, sms: int, lookahead: bool) -> CholPlan:
    panels = []
    for lo in range(0, m - KERNEL_BLOCK, KERNEL_BLOCK):
        n = m - lo - KERNEL_BLOCK
        tile = trail_tile(n, Bd, sms)
        if not lookahead:
            panels.append(PanelPlan(lo, n, tile, lower_tiles(n, tile)))
            continue
        side = max(-(-n // tile) - KERNEL_BLOCK // tile, 0)
        nxt = next_tile(n, Bd, sms)
        panels.append(PanelPlan(lo, n, tile, side * (side + 1) // 2, nxt, -(-n // nxt) * (KERNEL_BLOCK // nxt)))
    return CholPlan(m, Bd, lookahead, tuple(panels))


def stage_launches(plan: CholPlan) -> dict:
    """{CUDA kernel: launches} of one K6 call on ``plan``."""
    out = {"chol_init_kernel": 1, "chol_factor_kernel": len(plan.panels) + 1, "chol_solve_kernel": len(plan.panels)}
    for pp in plan.panels:
        for tile, blocks in ((pp.tile, pp.blocks), (pp.next_tile, pp.next_blocks)):
            if blocks:
                out[TRAIL_KERNELS[tile]] = out.get(TRAIL_KERNELS[tile], 0) + 1
    return out


def _check_plan(lib, plan: CholPlan) -> None:
    """Raise unless every tile of the plan has the shared-memory layout that
    the built kernel takes (the Python rule mirrors csrc/chol.cu)."""
    for tile in sorted({pp.tile for pp in plan.panels} | {pp.next_tile for pp in plan.panels if pp.next_tile}):
        cuda_bytes = lib.ogp_chol_trail_smem(tile)
        if cuda_bytes != trail_smem_bytes(tile):
            raise RuntimeError(f"blocked_cholesky's trailing update at tile {tile}: the plan takes "
                               f"{trail_smem_bytes(tile)} bytes of shared memory a block, the kernel's layout "
                               f"{cuda_bytes}; they must be changed together")


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
    _build.check_grid(Bd)
    out = torch.empty_like(q3)
    if out.numel() == 0:
        return out.view(q.shape), torch.zeros(q.shape[:-2], dtype=torch.int32, device=q.device)
    info = torch.empty((Bd,), dtype=torch.int32, device=q.device)  # chol_init_kernel zeros it
    _launch(q3, out, info, cholesky_plan(m, Bd, _build.card_sms(q.device)))
    blocked_cholesky.launches += 1
    return out.view(q.shape), info.view(q.shape[:-2])


def _launch(q3: torch.Tensor, out: torch.Tensor, info: torch.Tensor, plan: CholPlan) -> None:
    """K6's C entry on (Bd, m, m) q3 into out and info, on ``plan``."""
    lib = _chol_lib()
    _check_plan(lib, plan)
    Bd, m = plan.Bd, plan.m
    W = torch.empty((Bd, KERNEL_BLOCK // 32, 32, 32), dtype=torch.float32, device=q3.device)
    npanels = len(plan.panels)
    tiles = (ctypes.c_int * max(npanels, 1))(*(pp.tile for pp in plan.panels))
    next_tiles = (ctypes.c_int * max(npanels, 1))(*(pp.next_tile for pp in plan.panels))
    p_ = _build.ptr
    rc = lib.ogp_blocked_cholesky(p_(q3), p_(out), p_(W), p_(info), Bd, m, int(PROGRAMMATIC_LAUNCH),
                                  int(plan.lookahead), tiles, next_tiles, npanels, _build.stream_of(q3))
    if rc == BAD_PLAN:
        raise RuntimeError(f"blocked_cholesky: the C entry refused the plan {plan}; it is not the kernel's layout")
    _build.launch_check(rc, "blocked_cholesky")


def blocked_cholesky(q: torch.Tensor, block: int = 128) -> torch.Tensor:
    """K6: the lower Cholesky factor of SPD ``q`` (:func:`blocked_cholesky_ex`
    without the flag; the same launches)."""
    return blocked_cholesky_ex(q, block)[0]


# one count for both entries: each call of either that launched the kernel
blocked_cholesky.launches = 0
