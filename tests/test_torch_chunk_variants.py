"""Kernel K5 of online_gp_torch (the ``sub`` and ``mode="coord"`` options of
``blocked_chunk``) against the JAX package.

float32: the plain versions against ``pallas_blocked_chunk_batched`` with
the same options, run in interpret mode on the CPU at m = 96, k = 64,
Bd = 2, with the tolerances of tests/ops/test_pallas_batched.py: 2e-5 for
the two-level recursion, 5e-4 for the coordinate recursion, which takes
its inner products through the Gram matrix of the chunk's rows. The JAX
side densifies the stencil with ``stencil_rows`` as its callers do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops import root_update as jru
from online_gp_tpu.ops.pallas_root_update import pallas_blocked_chunk_batched
from online_gp_torch.ops import cuda_root_update as tcru

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
