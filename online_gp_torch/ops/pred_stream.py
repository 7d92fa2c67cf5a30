"""Blocked interleaved predict-then-condition streaming of the grid-space
predictive caches (port of ``online_gp_tpu/ops/pred_stream.py``).

The grid-space posterior N(mu, s2 C) conditions on one SKI observation
y_t = w_t^T u + eps as the rank-1 downdate

    beta_t = w_t^T C_{t-1} w_t + nz_t
    z_t    = C_{t-1} w_t / sqrt(beta_t)
    r_t    = (y_t - w_t^T mu_{t-1}) / sqrt(beta_t)
    mu_t   = mu_{t-1} + r_t z_t,      C_t = C_{t-1} - z_t z_t^T

and the prequential prediction at x_t is pred_mean_t = w_t^T mu_{t-1},
pred_var_t = w_t^T C_{t-1} w_t. Over a rank-k chunk,
C_{t-1} w_t = C_0 w_t - Z^T (Z w_t), so the O(m^2) updates wait for the
chunk boundary (C -= Z^T Z). Each chunk runs through kernel K3
(:func:`online_gp_torch.ops.cuda_pred_stream.pred_chunk`) on CUDA and
:func:`pred_chunk_plain` on the CPU; the chunks are a Python loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import check_stencil, pad_and_chunk_stream, stencil_rows


def pred_chunk_plain(C, mu, S, y, nz):
    """One rank-k predict-then-condition chunk, plain PyTorch (the
    counterpart of the JAX package's ``pred_chunk_xla``; any dtype).

    Args:
      C: (..., m, m) covariance cache; mu: (..., m) mean cache.
      S: (k, m) densified stencil rows (not noise-scaled), shared by the
        leading batch of C.
      y, nz: (..., k) targets and (clamped) noise.

    Returns new (C', mu', pred_mean (..., k), pred_var (..., k)).
    """
    return _pred_chunk(C, mu, S, y, nz, pred_chunk_factors)


def pred_chunk_stacked(C, mu, idx, wv, y, nz):
    """One chunk of the stream in a form autograd takes (never a kernel):
    :func:`pred_chunk_plain` on the stencil rows of ``idx``/``wv`` (k, P)
    with :func:`pred_chunk_factors_stacked`. Returns new tensors."""
    return _pred_chunk(C, mu, stencil_rows(idx, wv, C.shape[-1]), y, nz, pred_chunk_factors_stacked)


def _pred_chunk(C, mu, S, y, nz, factors):
    with f32_matmul_precision():
        c0w = S @ C  # (..., k, m): row t = (C_0 w_t)^T, C symmetric
        mu0w = mu @ S.mT  # (..., k)
        Z, r, pms, pvs = factors(S, c0w, mu0w, y, nz)
        new_C = C - Z.mT @ Z
        new_mu = mu + (Z.mT @ r[..., None])[..., 0]
    return new_C, new_mu, pms, pvs


def _pred_step(s_t, c0w_t, mu0w_t, y_t, nz_t, Z, r):
    """One step of the chunk recursion against the rows of Z and entries of
    r so far (any past them zero): returns the step's row of Z, its r, and
    its predicted mean and variance."""
    a = Z @ s_t  # (..., rows): a_j = z_j . w_t
    ct = c0w_t - (Z.mT @ a[..., None])[..., 0]  # C_{t-1} w_t
    wctw = ct @ s_t
    pm = mu0w_t + torch.sum(r * a, dim=-1)
    inv = torch.rsqrt(torch.clamp(wctw + nz_t, min=1e-20))
    return ct * inv[..., None], (y_t - pm) * inv, pm, wctw


def pred_chunk_factors(S, c0w, mu0w, y, nz):
    """The sequential factor recursion of one predict-then-condition chunk.

    Given c0w = S C_0 (..., k, m) and mu0w = S mu_0 (..., k), returns
    (Z (..., k, m), r (..., k), pred_mean (..., k), pred_var (..., k));
    the boundary updates C' = C - Z^T Z, mu' = mu + Z^T r are the
    caller's. Z's rows are filled in place, one per step
    (:func:`pred_chunk_factors_stacked` is the form autograd takes).
    """
    k = S.shape[0]
    Z = torch.zeros_like(c0w)
    r = torch.zeros_like(mu0w)
    pms, pvs = [], []
    with f32_matmul_precision():
        for t in range(k):
            step = (S[t], c0w[..., t, :], mu0w[..., t], y[..., t], nz[..., t])
            Z[..., t, :], r[..., t], pm, pv = _pred_step(*step, Z, r)
            pms.append(pm)
            pvs.append(pv)
    return Z, r, torch.stack(pms, dim=-1), torch.stack(pvs, dim=-1)


def pred_chunk_factors_stacked(S, c0w, mu0w, y, nz):
    """:func:`pred_chunk_factors` in a form autograd takes: each step
    appends its row of Z and its r with ``torch.cat`` and writes nothing in
    place (equal up to rounding)."""
    Z, r = c0w[..., :0, :], mu0w[..., :0]
    pms, pvs = [], []
    with f32_matmul_precision():
        for t in range(S.shape[0]):
            z, rt, pm, pv = _pred_step(S[t], c0w[..., t, :], mu0w[..., t], y[..., t], nz[..., t], Z, r)
            Z, r = torch.cat([Z, z[..., None, :]], dim=-2), torch.cat([r, rt[..., None]], dim=-1)
            pms.append(pm)
            pvs.append(pv)
    return Z, r, torch.stack(pms, dim=-1), torch.stack(pvs, dim=-1)


def _pad_chunk_aux(a: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """Pad a per-point (..., n) stream to a multiple of k and chunk it to
    (..., nc, k). Padding targets are 0 and padding noises 1: with the
    zero-weight stencil padding the padded steps are exact no-ops."""
    n = a.shape[-1]
    pad = (-n) % k
    if pad:
        a = torch.cat([a, a.new_full((*a.shape[:-1], pad), fill)], dim=-1)
    return a.reshape(*a.shape[:-1], -1, k)


def pred_stream_blocked_batched(
    C: torch.Tensor,
    mu: torch.Tensor,
    idx: torch.Tensor,
    wv: torch.Tensor,
    y: torch.Tensor,
    nz: torch.Tensor,
    block: int = 128,
    differentiable: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Interleaved predict-then-condition over a whole stream, blocked,
    batched over outputs: per point, predict from the caches conditioned
    on the points before it, then condition on it.

    Args:
      C: (Bd, m, m); mu: (Bd, m); idx, wv: (n, P) stencil shared by the
        outputs (not noise-scaled); y, nz: (Bd, n).
      block: chunk rank k.

    On CUDA the K3 kernel updates C and mu in place, chunk by chunk:
    treat the inputs as consumed. With ``differentiable`` every chunk is
    :func:`pred_chunk_stacked` instead, on any device: autograd runs
    through it, K3 is never called and nothing is updated in place.

    Returns (C', mu', pred_mean (Bd, n), pred_var (Bd, n)).
    """
    from online_gp_torch.ops.cuda_pred_stream import pred_chunk

    m = C.shape[-1]
    n = idx.shape[0]
    check_stencil(idx, m)
    idx_c, wv_c, k = pad_and_chunk_stream(idx, wv, block)
    idx_c = idx_c.to(torch.int32).contiguous()
    wv_c = wv_c.contiguous()
    y_c = _pad_chunk_aux(y, k, 0.0).transpose(0, 1).contiguous()  # (nc, Bd, k)
    nz_c = _pad_chunk_aux(nz, k, 1.0).transpose(0, 1).contiguous()
    C, mu = C.contiguous(), mu.contiguous()
    chunk = pred_chunk_stacked if differentiable else pred_chunk
    pms, pvs = [], []
    for c in range(idx_c.shape[0]):
        C, mu, pm, pv = chunk(C, mu, idx_c[c], wv_c[c], y_c[c], nz_c[c])
        pms.append(pm)
        pvs.append(pv)
    Bd = C.shape[0]
    if not pms:
        empty = C.new_zeros((Bd, 0))
        return C, mu, empty, empty
    return C, mu, torch.cat(pms, dim=-1)[:, :n], torch.cat(pvs, dim=-1)[:, :n]


def pred_stream_blocked(C, mu, idx, wv, y, nz, block: int = 128):
    """Single-output :func:`pred_stream_blocked_batched`: C (m, m),
    mu (m,), y, nz (n,). Returns (C', mu', pred_mean (n,), pred_var (n,));
    on CUDA, C and mu are updated in place."""
    Cb, mub, pm, pv = pred_stream_blocked_batched(
        C[None], mu[None], idx, wv, y[None], nz[None], block=block
    )
    return Cb[0], mub[0], pm[0], pv[0]
