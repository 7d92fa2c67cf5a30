"""online_gp_torch predict-then-condition streams against the JAX package.

- float64: the port's plain paths against the JAX XLA paths (one chunk
  1e-9, whole streams 1e-7).
- float32: the plain version of kernel K3 against the Pallas kernels it
  replaces (``pallas_pred_chunk`` at Bd=1, ``pallas_pred_chunk_batched``
  at Bd=2), run in interpret mode on the CPU at m=64, k=8, to 2e-4
  (tests/models/test_prequential_stream.py). The JAX side densifies the
  stencil with ``stencil_rows`` and pads m to 128, as its callers do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops import pred_stream as jps
from online_gp_tpu.ops.pallas_pred_stream import (
    pad_cache_to_tile,
    pallas_pred_chunk,
    pallas_pred_chunk_batched,
)
from online_gp_tpu.ops.root_update import stencil_rows as jstencil_rows
from online_gp_torch.ops import cuda_pred_stream as tcps
from online_gp_torch.ops import pred_stream as tps

TOL = 1e-9
STREAM_TOL = 1e-7


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def _problem(rng, Bd, m, n, P=4, dtype=np.float64):
    """Caches of a grid-space posterior and a stencil stream."""
    G = rng.normal(size=(Bd, m, m))
    C = G @ np.swapaxes(G, -1, -2) / m
    mu = rng.normal(size=(Bd, m))
    idx = rng.integers(0, m, (n, P))
    idx[:, 1] = idx[:, 0]  # duplicate indices within a row
    wv = rng.uniform(-0.3, 1.0, (n, P))
    y = rng.normal(size=(Bd, n))
    nz = rng.uniform(0.3, 0.7, (Bd, n))
    return [a.astype(dtype) for a in (C, mu)] + [idx] + [a.astype(dtype) for a in (wv, y, nz)]


def test_pred_chunk_plain_matches_xla():
    rng = np.random.default_rng(0)
    m, k = 20, 6
    C, mu, idx, wv, y, nz = _problem(rng, 1, m, k)
    S = np.asarray(jstencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv), m))
    outs_j = jps.pred_chunk_xla(jnp.asarray(C[0]), jnp.asarray(mu[0]), jnp.asarray(S), jnp.asarray(y[0]), jnp.asarray(nz[0]))
    outs_t = tps.pred_chunk_plain(torch.tensor(C[0]), torch.tensor(mu[0]), torch.tensor(S), torch.tensor(y[0]), torch.tensor(nz[0]))
    for a, b in zip(outs_j, outs_t):
        _close(a, b)


@pytest.mark.parametrize("n,block", [(21, 8), (5, 8), (16, 4)])
def test_pred_stream_blocked_matches_with_ragged_tail(n, block):
    rng = np.random.default_rng(n)
    m = 24
    C, mu, idx, wv, y, nz = _problem(rng, 2, m, n)
    jidx = jnp.asarray(idx, jnp.int32)
    outs_j = jps.pred_stream_blocked(
        jnp.asarray(C[0]), jnp.asarray(mu[0]), jidx, jnp.asarray(wv), jnp.asarray(y[0]), jnp.asarray(nz[0]),
        block=block, use_pallas=False,
    )
    outs_t = tps.pred_stream_blocked(
        torch.tensor(C[0]), torch.tensor(mu[0]), torch.tensor(idx), torch.tensor(wv), torch.tensor(y[0]),
        torch.tensor(nz[0]), block=block,
    )
    for a, b in zip(outs_j, outs_t):
        _close(a, b, STREAM_TOL)
    outs_j = jps.pred_stream_blocked_batched(
        jnp.asarray(C), jnp.asarray(mu), jidx, jnp.asarray(wv), jnp.asarray(y), jnp.asarray(nz),
        block=block, use_pallas=False,
    )
    outs_t = tps.pred_stream_blocked_batched(
        torch.tensor(C), torch.tensor(mu), torch.tensor(idx), torch.tensor(wv), torch.tensor(y),
        torch.tensor(nz), block=block,
    )
    for a, b in zip(outs_j, outs_t):
        _close(a, b, STREAM_TOL)


@pytest.mark.parametrize("Bd", [1, 2])
def test_pred_chunk_plain_matches_pallas(Bd):
    rng = np.random.default_rng(10 + Bd)
    m, k = 64, 8
    C, mu, idx, wv, y, nz = _problem(rng, Bd, m, k, dtype=np.float32)
    wv[3] = 0.0  # a zero-weight step predicts 0 and leaves the caches alone
    S = jstencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv), m)
    S = jnp.pad(S, ((0, 0), (0, 128 - m)))
    C_p, mu_p, m_pad = pad_cache_to_tile(jnp.asarray(C), jnp.asarray(mu))
    assert m_pad == 128
    if Bd == 1:
        Cj, muj, pmj, pvj = pallas_pred_chunk(C_p[0], mu_p[0], S, jnp.asarray(y[0]), jnp.asarray(nz[0]), interpret=True)
        Cj, muj, pmj, pvj = Cj[None], muj[None], pmj[None], pvj[None]
    else:
        Cj, muj, pmj, pvj = pallas_pred_chunk_batched(C_p, mu_p, S, jnp.asarray(y), jnp.asarray(nz), interpret=True)
    Ct, mut, pmt, pvt = tcps.pred_chunk(
        torch.tensor(C), torch.tensor(mu), torch.tensor(idx, dtype=torch.int32), torch.tensor(wv),
        torch.tensor(y), torch.tensor(nz),
    )
    _close(np.asarray(Cj)[:, :m, :m], Ct, 2e-4)
    _close(np.asarray(muj)[:, :m], mut, 2e-4)
    _close(pmj, pmt, 2e-4)
    _close(pvj, pvt, 2e-4)
    assert float(pvt[:, 3].abs().max()) == 0.0
