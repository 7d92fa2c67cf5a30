"""Kernel K5 of online_gp_torch (the ``sub`` and ``mode="coord"`` options of
``blocked_chunk``) against the JAX package.

float32: the plain versions against ``pallas_blocked_chunk_batched`` with
the same options, run in interpret mode on the CPU at m = 96, k = 64,
Bd = 2, with the tolerances of tests/ops/test_pallas_batched.py: 2e-5 for
the two-level recursion, 5e-4 for the coordinate recursion, which takes
its inner products through the Gram matrix of the chunk's rows. The JAX
side densifies the stencil with ``stencil_rows`` as its callers do.

The CUDA kernels compute the same chunks in another order, emulated here
in torch: K5 sub collapses its sub-blocks into one rank-k operator
(``collapse_sub_factors``; the kernel corrects each sub-block's rows in
one step with the collapsed P), and K5 coord carries the inner products
u_i . u_j, u_j . p0_l and p_j . p0_l instead of taking them through M, then
applies through the flat factors (Ut P0, Rt P0, Pt P0). Each emulation is
held against the plain recursion at float64 (1e-10) and against the
Pallas kernel at float32 (the tolerances above).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops import root_update as jru
from online_gp_tpu.ops.pallas_root_update import pallas_blocked_chunk_batched
from online_gp_torch.ops import cuda_root_update as tcru
from online_gp_torch.ops.root_update import (
    blocked_factors,
    blocked_factors_coord,
    blocked_factors_sub,
    collapse_sub_factors,
)

M, K, BD, P = 96, 64, 2, 4


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def _problem(seed):
    """Roots of W W^T/m + I and a stencil chunk, as numpy float32."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(BD, M, M))
    L = np.linalg.cholesky(W @ np.swapaxes(W, -1, -2) / M + np.eye(M))
    B = np.swapaxes(np.linalg.inv(L), -1, -2)
    idx = rng.integers(0, M, (K, P))
    idx[:, 1] = idx[:, 0]  # duplicate indices within a row
    wv = rng.uniform(-0.5, 1.0, (BD, K, P)) * np.array([1.0, 0.7])[:, None, None]
    return L.astype(np.float32), B.astype(np.float32), idx, wv.astype(np.float32)


def _both(L, B, idx, wv, **kw):
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv[b]), M)) for b in range(BD)])
    jL, jB = pallas_blocked_chunk_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(S), interpret=True, **kw)
    tL, tB = tcru.blocked_chunk(torch.tensor(L), torch.tensor(B), torch.tensor(idx, dtype=torch.int32), torch.tensor(wv), **kw)
    return (jL, jB), (tL, tB)


@pytest.mark.parametrize("sub", [16, 32])
def test_sub_blocked_chunk_matches_pallas(sub):
    L, B, idx, wv = _problem(sub)
    (jL, jB), (tL, tB) = _both(L, B, idx, wv, sub=sub)
    _close(jL, tL, 2e-5)
    _close(jB, tB, 2e-5)


def test_coord_chunk_matches_pallas_with_degenerate_rows():
    """A duplicated stencil row (a rank-deficient Gram matrix) and a
    zero-weight row (an exact no-op step)."""
    L, B, idx, wv = _problem(3)
    idx[5], wv[:, 5] = idx[2], wv[:, 2]
    wv[:, 40] = 0.0
    (jL, jB), (tL, tB) = _both(L, B, idx, wv, mode="coord")
    _close(jL, tL, 5e-4)
    _close(jB, tB, 5e-4)


@pytest.mark.parametrize("fn", [tcru.blocked_chunk, tcru.blocked_chunk_plain])
@pytest.mark.parametrize("kw,match", [
    (dict(sub=24), "must divide"),
    (dict(sub=0), "must divide"),
    (dict(mode="tree"), "unknown chunk-kernel mode"),
])
def test_chunk_options_are_checked(fn, kw, match):
    L, B, idx, wv = _problem(4)
    with pytest.raises(ValueError, match=match):
        fn(torch.tensor(L), torch.tensor(B), torch.tensor(idx, dtype=torch.int32), torch.tensor(wv), **kw)


# --------------------------------------------------------------------------
# the CUDA kernels' order of computation
# --------------------------------------------------------------------------


def _p0(L, B, idx, wv, dtype):
    """The chunk's raw rows p0 (Bd, k, m) = the stencil gather of B."""
    return torch.einsum("bkp,bkpm->bkm", torch.tensor(wv, dtype=dtype), torch.tensor(B, dtype=dtype)[:, torch.tensor(idx)])


def fused_sub_factors(p0, sub):
    """K5 sub's cluster kernel in its order: sub-block j's raw rows corrected
    in one step by the collapsed operator of the earlier ones,
    q += (q Pc_{<lo}^T) U_{<lo}, its local flat recursion, then its rows of
    Rc and Pc. Returns (U, Pc, Rc)."""
    k = p0.shape[-2]
    U, Pc, Rc = (torch.zeros_like(p0) for _ in range(3))
    for lo in range(0, k, sub):
        rows, done = slice(lo, lo + sub), slice(0, lo)
        q = p0[:, rows]
        q = q + (q @ Pc[:, done].mT) @ U[:, done]
        u, pj, rj = blocked_factors(q)
        U[:, rows] = u
        Rc[:, rows] = rj + (rj @ U[:, done].mT) @ Rc[:, done]
        Pc[:, rows] = pj + (pj @ U[:, done].mT) @ Pc[:, done]
    return U, Pc, Rc


def coord_tracker_factors(p0):
    """K5 coord's kernel in its order: (Ut, Pt, Rt) of p0 with the inner
    products carried as W = (u_i . u_j), Y = (u_j . p0_l) and
    Q = (p_j . p0_l) (l > j), and s^2 = M_tt + a . y + a . h."""
    Bd, k, _ = p0.shape
    M = p0 @ p0.mT
    Ut, Pt, Rt, W, Y, Q = (torch.zeros((Bd, k, k), dtype=p0.dtype) for _ in range(6))
    for t in range(k):
        a, y = Q[:, :t, t], Y[:, :t, t]
        h = y + (W[:, :t, :t] @ a[..., None])[..., 0]
        pi = torch.zeros((Bd, k), dtype=p0.dtype)
        pi[:, t] = 1.0
        pi[:, :t] += (Ut[:, :t, :t].mT @ a[..., None])[..., 0]
        s2 = torch.clamp(M[:, t, t] + (a * y).sum(-1) + (a * h).sum(-1), min=0.0)[:, None]
        s = torch.sqrt(s2)
        inv_s = torch.where(s > 1e-20, 1.0 / torch.clamp(s, min=1e-20), torch.zeros_like(s))
        c, d = torch.sqrt(s2 + 1.0) - 1.0, 1.0 / torch.sqrt(s2 + 1.0) - 1.0
        alpha = pi * inv_s
        Pt[:, t] = d * (alpha + (Pt[:, :t].mT @ h[..., None])[..., 0] * inv_s)
        Rt[:, t] = c * (alpha + (Rt[:, :t].mT @ h[..., None])[..., 0] * inv_s)
        Ut[:, t] = alpha
        W[:, t, :t] = W[:, :t, t] = h * inv_s
        W[:, t, t] = (s2 * inv_s * inv_s)[:, 0]
        yt = (M[:, t] + (Y[:, :t].mT @ a[..., None])[..., 0]) * inv_s
        qt = d * (yt + (Q[:, :t].mT @ h[..., None])[..., 0] * inv_s)
        Y[:, t, t + 1 :], Q[:, t, t + 1 :] = yt[:, t + 1 :], qt[:, t + 1 :]
    return Ut, Pt, Rt


def _degenerate_problem(seed):
    """A duplicated stencil row and a zero-weight row, as in the coord test."""
    L, B, idx, wv = _problem(seed)
    idx[5], wv[:, 5] = idx[2], wv[:, 2]
    wv[:, 40] = 0.0
    return L, B, idx, wv


def _pallas(L, B, idx, wv, **kw):
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv[b]), M)) for b in range(BD)])
    return pallas_blocked_chunk_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(S), interpret=True, **kw)


@pytest.mark.parametrize("sub", [16, 32])
def test_collapsed_sub_factors_are_the_sub_chunk_at_f64(sub):
    """(a) L + (L Rc^T) U and B + (B Pc^T) U, one rank-k apply, against the
    plain two-level chunk (one apply per sub-block)."""
    L, B, idx, wv = _problem(20 + sub)
    p0 = _p0(L, B, idx, wv, torch.float64)
    U, Pm, R = blocked_factors_sub(p0, sub)
    Rc, Pc = collapse_sub_factors(U, Pm, R, sub)
    Ld, Bd_ = torch.tensor(L, dtype=torch.float64), torch.tensor(B, dtype=torch.float64)
    want = tcru.blocked_chunk_plain(Ld, Bd_, torch.tensor(idx), torch.tensor(wv, dtype=torch.float64), sub=sub)
    _close(want[0], Ld + (Ld @ Rc.mT) @ U, 1e-10)
    _close(want[1], Bd_ + (Bd_ @ Pc.mT) @ U, 1e-10)
    # the kernel's order (one-step corrections with the collapsed P) is the
    # same factors to rounding
    for a, b in zip((U, Pc, Rc), fused_sub_factors(p0, sub)):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("sub", [16, 32])
def test_collapsed_sub_factors_match_pallas_at_f32(sub):
    """(b) the collapsed form, and the kernel's order, at float32 against the
    Pallas kernel with the same sub."""
    L, B, idx, wv = _problem(30 + sub)
    jL, jB = _pallas(L, B, idx, wv, sub=sub)
    p0 = _p0(L, B, idx, wv, torch.float32)
    Lt, Bt = torch.tensor(L), torch.tensor(B)
    U, Pm, R = blocked_factors_sub(p0, sub)
    for U_, Pc, Rc in ((U, *collapse_sub_factors(U, Pm, R, sub)[::-1]), fused_sub_factors(p0, sub)):
        _close(jL, Lt + (Lt @ Rc.mT) @ U_, 2e-5)
        _close(jB, Bt + (Bt @ Pc.mT) @ U_, 2e-5)


def test_coord_factors_are_lower_triangular():
    """(c) row t of Ut, Pt, Rt has support in columns <= t, exactly, on the
    degenerate-row input: the kernel keeps only these triangles."""
    L, B, idx, wv = _degenerate_problem(3)
    for dtype in (torch.float32, torch.float64):
        for F in blocked_factors_coord(_p0(L, B, idx, wv, dtype)):
            assert torch.count_nonzero(torch.triu(F, 1)) == 0


def test_coord_apply_through_flat_factors_at_f64():
    """(d) the kernel applies through the flat factors, X + (X (Rt P0)^T)(Ut P0),
    where the Pallas kernel applies X + ((X P0^T)(Rt^T Ut)) P0: the same
    operator, and the carried inner products give the same factors."""
    L, B, idx, wv = _degenerate_problem(5)
    p0 = _p0(L, B, idx, wv, torch.float64)
    Ut, Pt, Rt = blocked_factors_coord(p0)
    Ld, Bd_ = torch.tensor(L, dtype=torch.float64), torch.tensor(B, dtype=torch.float64)
    for X, A in ((Ld, Rt), (Bd_, Pt)):
        pallas_order = X + ((X @ p0.mT) @ (A.mT @ Ut)) @ p0
        _close(pallas_order, X + (X @ (A @ p0).mT) @ (Ut @ p0), 1e-10)
    for a, b in zip((Ut, Pt, Rt), coord_tracker_factors(p0)):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("degenerate", [False, True])
def test_coord_kernel_order_matches_pallas_at_f32(degenerate):
    L, B, idx, wv = (_degenerate_problem if degenerate else _problem)(6)
    jL, jB = _pallas(L, B, idx, wv, mode="coord")
    p0 = _p0(L, B, idx, wv, torch.float32)
    Ut, Pt, Rt = coord_tracker_factors(p0)
    Lt, Bt = torch.tensor(L), torch.tensor(B)
    U = Ut @ p0
    _close(jL, Lt + (Lt @ (Rt @ p0).mT) @ U, 5e-4)
    _close(jB, Bt + (Bt @ (Pt @ p0).mT) @ U, 5e-4)
