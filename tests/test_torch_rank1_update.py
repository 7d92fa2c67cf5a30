"""Kernel K4 of online_gp_torch (``rank1_update``, ``fused_root_cache_update``)
against the JAX package.

- float32: the plain version against the Pallas kernels it replaces, run
  in interpret mode on the CPU as the JAX package's own tests run them
  (tests/ops/test_pallas_root_update.py, tests/ops/test_pallas_batched.py):
  one update 1e-5, eight sequential updates 2e-4, at m = 130 (a 2-row
  edge tile at the Pallas tile of 128) and m = 100.
- float64: the CPU path of ``fused_root_cache_update`` against the JAX
  dispatcher, which routes float64 to the XLA ``root_cache_update``
  (1e-10).

The inputs are made with numpy and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops import root_update as jru
from online_gp_tpu.ops.pallas_root_update import (
    pallas_rank1_update,
    pallas_rank1_update_batched,
    pallas_rank1_update_slim,
    pallas_rank1_update_slim_batched,
    pallas_root_cache_update,
)
from online_gp_torch.ops import cuda_root_update as tcru
from online_gp_torch.ops import root_update as tru


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def _cache(rng, Bd, m, dtype=np.float32):
    """(A, L, B) with A = W W^T/m + I, L its Cholesky factor, B = L^{-T}."""
    W = rng.normal(size=(Bd, m, m))
    A = W @ np.swapaxes(W, -1, -2) / m + np.eye(m)
    L = np.linalg.cholesky(A)
    B = np.swapaxes(np.linalg.inv(L), -1, -2)
    return tuple(x.astype(dtype) for x in (A, L, B))


def _torch_update(A, L, B, v, slim):
    """The port's rank1_update on CPU tensors; returns numpy (L', B', A')."""
    out = tcru.rank1_update(torch.tensor(L), torch.tensor(B), None if slim else torch.tensor(A), torch.tensor(v))
    return tuple(None if x is None else x.numpy() for x in out)


@pytest.mark.parametrize("slim", [False, True])
def test_rank1_update_plain_matches_pallas(slim):
    rng = np.random.default_rng(30 + slim)
    m = 130
    A, L, B = _cache(rng, 1, m)
    v = rng.normal(size=(1, m, 1)).astype(np.float32)
    if slim:
        jL, jB = pallas_rank1_update_slim(jnp.asarray(L[0]), jnp.asarray(B[0]), jnp.asarray(v[0]), interpret=True)
    else:
        jL, jB, jA = pallas_rank1_update(jnp.asarray(L[0]), jnp.asarray(B[0]), jnp.asarray(A[0]), jnp.asarray(v[0]), interpret=True)
    tL, tB, tA = _torch_update(A, L, B, v, slim)
    _close(jL, tL[0], 1e-5)
    _close(jB, tB[0], 1e-5)
    if slim:
        assert tA is None
    else:
        _close(jA, tA[0], 1e-5)


@pytest.mark.parametrize("Bd,slim", [(2, False), (3, True)])
def test_rank1_update_plain_matches_pallas_batched(Bd, slim):
    rng = np.random.default_rng(40 + Bd)
    m = 100
    A, L, B = _cache(rng, Bd, m)
    v = rng.normal(size=(Bd, m, 1)).astype(np.float32)
    J = jnp.asarray
    if slim:
        jL, jB = pallas_rank1_update_slim_batched(J(L), J(B), J(v), interpret=True)
    else:
        jL, jB, jA = pallas_rank1_update_batched(J(L), J(B), J(A), J(v), interpret=True)
    tL, tB, tA = _torch_update(A, L, B, v, slim)
    _close(jL, tL, 1e-5)
    _close(jB, tB, 1e-5)
    if not slim:
        _close(jA, tA, 1e-5)


def test_rank1_update_zero_vector_is_exact_noop():
    """|p| = 0: u = 0 and c = d = 0 in both guards, so the roots and A come
    back bit for bit, not NaN (tests/ops/test_pallas_root_update.py)."""
    rng = np.random.default_rng(50)
    m = 130
    A, L, B = _cache(rng, 1, m)
    v = np.zeros((1, m, 1), np.float32)
    jL, jB, jA = pallas_rank1_update(jnp.asarray(L[0]), jnp.asarray(B[0]), jnp.asarray(A[0]), jnp.asarray(v[0]), interpret=True)
    tL, tB, tA = _torch_update(A, L, B, v, slim=False)
    for j, t, x in [(jL, tL, L), (jB, tB, B), (jA, tA, A)]:
        np.testing.assert_array_equal(t, x)
        np.testing.assert_allclose(np.asarray(j), x[0], atol=1e-7)


@pytest.mark.parametrize("slim", [False, True])
def test_rank1_update_zero_vector_in_a_batch_is_exact_noop(slim):
    """v = 0 (so p = 0) on one output of a batch: that output comes back
    bit for bit while the others match the batched Pallas kernel."""
    rng = np.random.default_rng(55 + slim)
    Bd, m = 3, 100
    A, L, B = _cache(rng, Bd, m)
    v = rng.normal(size=(Bd, m, 1)).astype(np.float32)
    v[1] = 0.0
    J = jnp.asarray
    if slim:
        jL, jB = pallas_rank1_update_slim_batched(J(L), J(B), J(v), interpret=True)
    else:
        jL, jB, jA = pallas_rank1_update_batched(J(L), J(B), J(A), J(v), interpret=True)
    tL, tB, tA = _torch_update(A, L, B, v, slim)
    np.testing.assert_array_equal(tL[1], L[1])
    np.testing.assert_array_equal(tB[1], B[1])
    _close(jL, tL, 1e-5)
    _close(jB, tB, 1e-5)
    if slim:
        assert tA is None
    else:
        np.testing.assert_array_equal(tA[1], A[1])
        _close(jA, tA, 1e-5)


def test_rank1_update_sequential_tracks_pallas_and_keeps_invariants():
    """Eight sequential updates: the port and the Pallas kernel stay within
    2e-4, and L L^T = A, B^T L = I hold as in the JAX test."""
    rng = np.random.default_rng(60)
    m = 130
    A, L, B = _cache(rng, 1, m)
    jL, jB, jA = jnp.asarray(L[0]), jnp.asarray(B[0]), jnp.asarray(A[0])
    tL, tB, tA = (torch.tensor(x) for x in (L, B, A))
    for _ in range(8):
        v = (0.5 * rng.normal(size=(1, m, 1))).astype(np.float32)
        jL, jB, jA = pallas_rank1_update(jL, jB, jA, jnp.asarray(v[0]), interpret=True)
        tL, tB, tA = tcru.rank1_update(tL, tB, tA, torch.tensor(v))
    _close(jL, tL[0], 2e-4)
    _close(jB, tB[0], 2e-4)
    _close(jA, tA[0], 2e-4)
    np.testing.assert_allclose((tL[0] @ tL[0].T).numpy(), tA[0].numpy(), rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose((tB[0].T @ tL[0]).numpy(), np.eye(m), atol=5e-4)


@pytest.mark.parametrize("slim", [False, True])
@pytest.mark.parametrize("q", [1, 2])
def test_fused_root_cache_update_matches_pallas_dispatcher(q, slim):
    """q = 1 rides K4 (full or slim); q > 1 routes by shape to
    root_cache_update in both packages."""
    rng = np.random.default_rng(70 + q)
    Bd, m = (3, 100) if slim else (2, 100)
    A, L, B = _cache(rng, Bd, m)
    v = rng.normal(size=(Bd, m, q)).astype(np.float32)
    jc = jru.RootCache(mat=None if slim else jnp.asarray(A), root=jnp.asarray(L), inv_root=jnp.asarray(B))
    tc = tru.RootCache(mat=None if slim else torch.tensor(A), root=torch.tensor(L), inv_root=torch.tensor(B))
    jo = pallas_root_cache_update(jc, jnp.asarray(v), interpret=True)
    to = tcru.fused_root_cache_update(tc, torch.tensor(v))
    _close(jo.root, to.root, 1e-5)
    _close(jo.inv_root, to.inv_root, 1e-5)
    if slim:
        assert jo.mat is None and to.mat is None
    else:
        _close(jo.mat, to.mat, 1e-5)


@pytest.mark.parametrize("slim", [False, True])
def test_fused_root_cache_update_unbatched_q1_matches_pallas(slim):
    """An (m, m) cache with v (m, 1) rides K4 as a batch of one: it matches
    the unbatched Pallas kernel and the JAX dispatcher (XLA for this shape),
    and comes back unbatched."""
    rng = np.random.default_rng(75 + slim)
    m = 130
    A, L, B = (x[0] for x in _cache(rng, 1, m))
    v = rng.normal(size=(m, 1)).astype(np.float32)
    J = jnp.asarray
    if slim:
        jL, jB = pallas_rank1_update_slim(J(L), J(B), J(v), interpret=True)
    else:
        jL, jB, jA = pallas_rank1_update(J(L), J(B), J(A), J(v), interpret=True)
    jc = jru.RootCache(mat=None if slim else J(A), root=J(L), inv_root=J(B))
    jo = pallas_root_cache_update(jc, J(v), interpret=True)
    tc = tru.RootCache(mat=None if slim else torch.tensor(A), root=torch.tensor(L), inv_root=torch.tensor(B))
    to = tcru.fused_root_cache_update(tc, torch.tensor(v))
    assert to.root.shape == to.inv_root.shape == (m, m)
    for want in ((jL, jB), (jo.root, jo.inv_root)):
        _close(want[0], to.root, 1e-5)
        _close(want[1], to.inv_root, 1e-5)
    if slim:
        assert to.mat is None
    else:
        assert to.mat.shape == (m, m)
        _close(jA, to.mat, 1e-5)
        _close(jo.mat, to.mat, 1e-5)


def test_fused_root_cache_update_float64_on_cpu():
    """float64 takes the plain path on the CPU; the JAX dispatcher sends it
    to XLA. Both are root_cache_update at q = 1."""
    rng = np.random.default_rng(80)
    A, L, B = _cache(rng, 2, 32, np.float64)
    v = rng.normal(size=(2, 32, 1))
    jc = jru.RootCache(mat=jnp.asarray(A), root=jnp.asarray(L), inv_root=jnp.asarray(B))
    tc = tru.RootCache(mat=torch.tensor(A), root=torch.tensor(L), inv_root=torch.tensor(B))
    jo = pallas_root_cache_update(jc, jnp.asarray(v), interpret=True)
    to = tcru.fused_root_cache_update(tc, torch.tensor(v))
    assert to.root.dtype == torch.float64
    _close(jo.root, to.root, 1e-10)
    _close(jo.inv_root, to.inv_root, 1e-10)
    _close(jo.mat, to.mat, 1e-10)
