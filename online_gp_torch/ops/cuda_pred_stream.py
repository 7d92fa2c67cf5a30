"""Kernel K3 (``pred_chunk``): one predict-then-condition chunk on the
card, beside its plain PyTorch version.

K3 replaces ``pallas_pred_chunk`` and ``pallas_pred_chunk_batched``
(``online_gp_tpu/ops/pallas_pred_stream.py``), one kernel for both: the
stencil is shared by the outputs and the caches carry a leading batch
dim (Bd = 1 for a single output). The CUDA source, with the design notes,
is ``online_gp_torch/csrc/pred_stream.cu``. The caches are not padded to
a lane-tile multiple: the kernel masks its own ragged edge.

Dispatch, by the tensors given: on the CPU the plain version runs; on
CUDA with float32 (int32 indices) the kernel launches; anything else
raises and names the plain version. On CUDA the caches are updated in
place. ``pred_chunk.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from online_gp_torch.ops import _build
from online_gp_torch.ops.pred_stream import pred_chunk_plain
from online_gp_torch.ops.root_update import stencil_rows

MAX_CHUNK = 1024
MAX_SHARED_BYTES = 232448
MAX_GRID_YZ = 65535

_lib = None


def _pred_stream_lib():
    global _lib
    if _lib is None:
        lib = _build.load("pred_stream")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ogp_pred_chunk.argtypes = [vp] * 12 + [i32] * 4 + [vp]
        lib.ogp_pred_chunk.restype = i32
        lib.ogp_pred_chunk_smem.argtypes = [i32, i32]
        lib.ogp_pred_chunk_smem.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def pred_chunk_stencil_plain(C, mu, idx, wv, y, nz):
    """Plain version of K3: :func:`pred_chunk_plain` on the densified
    stencil rows. Returns new (C', mu', pred_mean, pred_var)."""
    return pred_chunk_plain(C, mu, stencil_rows(idx, wv, C.shape[-1]), y, nz)


def pred_chunk(C, mu, idx, wv, y, nz):
    """K3: one rank-k predict-then-condition chunk, batched over outputs.

    Args:
      C: (Bd, m, m) covariance caches; mu: (Bd, m) mean caches.
      idx: (k, P) stencil indices in [0, m) (int32 on CUDA); wv: (k, P)
        stencil weights (not noise-scaled); both shared by the outputs.
      y, nz: (Bd, k) targets and clamped noise.

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
    if idx.dim() != 2 or wv.shape != idx.shape:
        raise ValueError(f"idx and wv must be (k, P); got {tuple(idx.shape)}, {tuple(wv.shape)}")
    k, P = idx.shape
    if tuple(mu.shape) != (Bd, m) or tuple(y.shape) != (Bd, k) or tuple(nz.shape) != (Bd, k):
        raise ValueError(
            f"mu must be ({Bd}, {m}) and y, nz ({Bd}, {k}); got "
            f"{tuple(mu.shape)}, {tuple(y.shape)}, {tuple(nz.shape)}"
        )
    if Bd * m * m >= 2**31 or Bd > MAX_GRID_YZ:
        raise ValueError(f"(Bd={Bd}, m={m}) exceeds what the K3 kernel takes")
    lib = _pred_stream_lib()
    if k > MAX_CHUNK or lib.ogp_pred_chunk_smem(k, m) > MAX_SHARED_BYTES:
        raise ValueError(f"chunk (k={k}, m={m}) exceeds what the K3 kernel takes (k <= {MAX_CHUNK}, "
                         f"(m + 2k + 1) floats of shared memory <= {MAX_SHARED_BYTES} bytes)")
    dev = C.device
    f32 = dict(dtype=torch.float32, device=dev)
    c0w = torch.empty((Bd, k, m), **f32)
    Z = torch.empty((Bd, k, m), **f32)
    vecs = torch.empty((4, Bd, k), **f32)  # mu0w, r, pred_mean, pred_var
    p_ = _build.ptr
    rc = lib.ogp_pred_chunk(
        p_(C), p_(mu), p_(idx), p_(wv), p_(y), p_(nz), p_(c0w), p_(vecs[0]), p_(Z),
        p_(vecs[1]), p_(vecs[2]), p_(vecs[3]), Bd, k, P, m, _build.stream_of(C),
    )
    _build.launch_check(rc, "pred_chunk")
    pred_chunk.launches += 1
    return C, mu, vecs[2], vecs[3]


pred_chunk.launches = 0
