"""Kernel K6 of online_gp_torch (``blocked_cholesky``) against the JAX
package.

float32: the plain version against the Pallas ``blocked_cholesky``, run
in interpret mode on the CPU, and against ``numpy.linalg.cholesky``, at
the shapes and tolerances of tests/ops/test_pallas_chol.py (atol 2e-5,
rtol 1e-4): m not a multiple of the block, a batch, and two batch dims
(the JAX function vmaps any number; the CUDA wrapper flattens them). At
the main path's m = 900 and block 128 (a ragged last panel of 4 columns)
the plain version is held against numpy alone: the Pallas kernel in
interpret mode is too slow at that size. The strict upper triangle must
be exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops.pallas_chol import blocked_cholesky as jblocked_cholesky
from online_gp_torch.ops.cuda_chol import blocked_cholesky


def _spd(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    m = shape[-1]
    return a @ np.swapaxes(a, -1, -2) / m + np.eye(m, dtype=np.float32)


@pytest.mark.parametrize("shape,block", [((64, 64), 64), ((150, 150), 64), ((320, 320), 128), ((3, 200, 200), 64)])
def test_blocked_cholesky_matches_pallas_and_numpy(shape, block):
    q = _spd(shape, seed=shape[-1])
    got = blocked_cholesky(torch.tensor(q), block=block).numpy()
    assert got.shape == q.shape
    pallas = np.asarray(jblocked_cholesky(jnp.asarray(q), block=block, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.linalg.cholesky(q), atol=2e-5, rtol=1e-4)
    m = shape[-1]
    assert np.all(got[..., np.triu_indices(m, k=1)[0], np.triu_indices(m, k=1)[1]] == 0.0)


def _upper_is_zero(got):
    m = got.shape[-1]
    rows, cols = np.triu_indices(m, k=1)
    return np.all(got[..., rows, cols] == 0.0)


def test_blocked_cholesky_two_batch_dims_match_pallas():
    q = _spd((2, 2, 64, 64), seed=7)
    got = blocked_cholesky(torch.tensor(q), block=64).numpy()
    assert got.shape == q.shape
    pallas = np.asarray(jblocked_cholesky(jnp.asarray(q), block=64, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.linalg.cholesky(q), atol=2e-5, rtol=1e-4)
    assert _upper_is_zero(got)


def test_blocked_cholesky_main_path_size_matches_numpy():
    q = _spd((900, 900), seed=900)
    got = blocked_cholesky(torch.tensor(q), block=128).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(q.astype(np.float64)), atol=2e-5, rtol=1e-4)
    assert _upper_is_zero(got)
