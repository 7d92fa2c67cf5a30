"""online_gp_torch factorizations and maintained-root updates against the
JAX package.

- float64: the port's plain paths against the JAX XLA paths (single ops
  1e-9, whole streams 1e-7).
- float32: the plain versions of kernels K2 and K1 against the Pallas
  kernels they replace, run in interpret mode on the CPU as the JAX
  package's own tests run them (1e-5, tests/ops/test_pallas_batched.py),
  at m=64, k=8, Bd in {1, 2}. The JAX side densifies the stencil with
  ``stencil_rows`` as its callers do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops import chol as jchol
from online_gp_tpu.ops import root_update as jru
from online_gp_tpu.ops.pallas_root_update import (
    pallas_blocked_chunk_batched,
    pallas_rank1_apply_batched,
)
from online_gp_torch.ops import chol as tchol
from online_gp_torch.ops import cuda_root_update as tcru
from online_gp_torch.ops import root_update as tru

TOL = 1e-9
STREAM_TOL = 1e-7


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def _spd(rng, batch, m, ridge=1.0):
    W = rng.normal(size=(*batch, m, m))
    return W @ np.swapaxes(W, -1, -2) / m + ridge * np.eye(m)


def _roots(rng, batch, m, dtype=np.float64):
    """(L, B) of a well-conditioned SPD matrix, computed with numpy."""
    L = np.linalg.cholesky(_spd(rng, batch, m))
    B = np.swapaxes(np.linalg.inv(L), -1, -2)
    return L.astype(dtype), B.astype(dtype)


def _stencil(rng, n, P, m):
    idx = rng.integers(0, m, (n, P))
    idx[:, 1] = idx[:, 0]  # duplicate indices within a row
    return idx, rng.uniform(-0.5, 1.0, (n, P))


# --------------------------------------------------------------------------
# chol
# --------------------------------------------------------------------------


def test_psd_safe_cholesky_matches_with_jitter_escalation():
    rng = np.random.default_rng(0)
    m = 10
    good = _spd(rng, (), m)
    V = np.linalg.qr(rng.normal(size=(m, m)))[0]
    bad = V @ np.diag(np.r_[np.linspace(1.0, 2.0, m - 1), -5e-6]) @ V.T  # level 0 fails
    mats = np.stack([good, bad])
    for jitter, tries in [(1e-6, 3), (1e-8, 5)]:
        jl = jchol.psd_safe_cholesky(jnp.asarray(mats), jitter=jitter, tries=tries)
        tl = tchol.psd_safe_cholesky(torch.tensor(mats), jitter=jitter, tries=tries)
        _close(jl, tl)
    # no level factors: NaN, as jnp.linalg.cholesky returns
    worse = V @ np.diag(np.r_[np.ones(m - 1), -1.0]) @ V.T
    tl = tchol.psd_safe_cholesky(torch.tensor(worse), tries=2)
    jl = np.asarray(jchol.psd_safe_cholesky(jnp.asarray(worse), tries=2))
    np.testing.assert_array_equal(torch.isnan(tl).numpy(), np.isnan(jl))
    assert torch.isnan(tl.diagonal()).all()


def test_triangular_helpers_match():
    rng = np.random.default_rng(1)
    L = np.linalg.cholesky(_spd(rng, (2,), 9))
    rhs = rng.normal(size=(2, 9, 3))
    jL, tL = jnp.asarray(L), torch.tensor(L)
    for trans in (False, True):
        _close(jchol.tri_solve(jL, jnp.asarray(rhs), trans=trans), tchol.tri_solve(tL, torch.tensor(rhs), trans=trans))
    _close(jchol.cho_solve(jL, jnp.asarray(rhs)), tchol.cho_solve(tL, torch.tensor(rhs)))
    _close(jchol.chol_logdet(jL), tchol.chol_logdet(tL))
    _close(jchol.inv_lower_transpose(jL), tchol.inv_lower_transpose(tL))


# --------------------------------------------------------------------------
# roots, float64 against XLA
# --------------------------------------------------------------------------


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("slim", [False, True])
def test_root_cache_update_matches(q, slim):
    rng = np.random.default_rng(q)
    A = _spd(rng, (2,), 16, ridge=0.3)
    jc = jru.root_cache_init(jnp.asarray(A))
    tc = tru.root_cache_init(torch.tensor(A))
    _close(jc.root, tc.root)
    _close(jc.inv_root, tc.inv_root)
    if slim:
        jc, tc = jru.root_cache_slim(jc), tru.root_cache_slim(tc)
    v = rng.normal(size=(2, 16, q))
    v[1, :, 0] = 0.0  # a zero direction is an exact no-op
    jn = jru.root_cache_update(jc, jnp.asarray(v))
    tn = tru.root_cache_update(tc, torch.tensor(v))
    _close(jn.root, tn.root)
    _close(jn.inv_root, tn.inv_root)
    if slim:
        assert tn.mat is None
        _close(jru.root_cache_rebuild_mat(jn).mat, tru.root_cache_rebuild_mat(tn).mat)
    else:
        _close(jn.mat, tn.mat)


def test_roots_apply_rank1_p_and_blocked_factors_match():
    rng = np.random.default_rng(5)
    L, B = _roots(rng, (3,), 12)
    p = rng.normal(size=(3, 12))
    p[1] = 0.0
    jL, jB = jru.roots_apply_rank1_p(jnp.asarray(L), jnp.asarray(B), jnp.asarray(p))
    tL, tB = tru.roots_apply_rank1_p(torch.tensor(L), torch.tensor(B), torch.tensor(p))
    _close(jL, tL)
    _close(jB, tB)
    p0 = rng.normal(size=(6, 12))
    p0[3] = 0.0
    for a, b in zip(jru.blocked_factors_xla(jnp.asarray(p0)), tru.blocked_factors(torch.tensor(p0))):
        _close(a, b)


@pytest.mark.parametrize("n,block", [(21, 8), (5, 8)])
def test_roots_stream_blocked_matches_with_ragged_tail(n, block):
    rng = np.random.default_rng(n)
    m, P = 16, 4
    L, B = _roots(rng, (2,), m)
    idx, w = _stencil(rng, n, P, m)
    wv = w[None] * np.array([1.0, 0.7])[:, None, None]
    jidx = jnp.asarray(idx, jnp.int32)
    jL, jB = jru.roots_stream_blocked(jnp.asarray(L[0]), jnp.asarray(B[0]), jidx, jnp.asarray(wv[0]), block=block, use_pallas=False)
    tL, tB = tru.roots_stream_blocked(torch.tensor(L[0]), torch.tensor(B[0]), torch.tensor(idx), torch.tensor(wv[0]), block=block)
    _close(jL, tL, STREAM_TOL)
    _close(jB, tB, STREAM_TOL)
    jL, jB = jru.roots_stream_blocked_batched(jnp.asarray(L), jnp.asarray(B), jidx, jnp.asarray(wv), block=block, use_pallas=False)
    tL, tB = tru.roots_stream_blocked_batched(torch.tensor(L), torch.tensor(B), torch.tensor(idx), torch.tensor(wv), block=block)
    _close(jL, tL, STREAM_TOL)
    _close(jB, tB, STREAM_TOL)


def test_roots_stream_rejects_out_of_range_stencil():
    L, B = _roots(np.random.default_rng(6), (1,), 8)
    idx = torch.tensor([[0, 8]])
    with pytest.raises(ValueError, match="stencil indices"):
        tru.roots_stream_blocked_batched(torch.tensor(L), torch.tensor(B), idx, torch.ones((1, 1, 2), dtype=torch.float64))


# --------------------------------------------------------------------------
# kernel plain versions, float32 against the Pallas kernels (interpret)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("Bd", [1, 2])
def test_rank1_apply_plain_matches_pallas(Bd):
    rng = np.random.default_rng(10 + Bd)
    m = 64
    L, B = _roots(rng, (Bd,), m, np.float32)
    p = rng.normal(size=(Bd, m)).astype(np.float32)
    p[-1] = 0.0  # p = 0: both guards make the update an exact no-op
    jL, jB = pallas_rank1_apply_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(p), interpret=True)
    tL, tB = tcru.rank1_apply(torch.tensor(L), torch.tensor(B), torch.tensor(p))
    _close(jL, tL, 1e-5)
    _close(jB, tB, 1e-5)
    np.testing.assert_array_equal(tL[-1].numpy(), L[-1])
    np.testing.assert_array_equal(tB[-1].numpy(), B[-1])


@pytest.mark.parametrize("Bd", [1, 2])
def test_blocked_chunk_plain_matches_pallas(Bd):
    rng = np.random.default_rng(20 + Bd)
    m, k, P = 64, 8, 4
    L, B = _roots(rng, (Bd,), m, np.float32)
    idx, w = _stencil(rng, k, P, m)
    w[5] = 0.0  # a zero-weight (padding) row is an exact no-op step
    wv = (w[None] * np.linspace(1.0, 0.6, Bd)[:, None, None]).astype(np.float32)
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv[b]), m)) for b in range(Bd)])
    jL, jB = pallas_blocked_chunk_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(S), interpret=True)
    tL, tB = tcru.blocked_chunk(torch.tensor(L), torch.tensor(B), torch.tensor(idx, dtype=torch.int32), torch.tensor(wv))
    _close(jL, tL, 1e-5)
    _close(jB, tB, 1e-5)
    for b in range(Bd):
        _close(S[b], tru.stencil_rows(torch.tensor(idx), torch.tensor(wv[b]), m), 0)
