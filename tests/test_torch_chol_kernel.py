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


# ---------------------------------------------------------------------------
# the failure flag and spd_cholesky's route
# ---------------------------------------------------------------------------


def _indefinite_batch(m, dtype):
    """(5, m, m): SPD, one negative eigenvalue, SPD, a NaN on the diagonal,
    and a zero eigenvalue's neighbour (-1e-3)."""
    rng = np.random.default_rng(m)
    qs = []
    for i, low in enumerate((0.5, -1.0, 0.3, 0.5, -1e-3)):
        V, _ = np.linalg.qr(rng.standard_normal((m, m)))
        lam = rng.uniform(0.5, 3.0, m)
        lam[rng.integers(m)] = low
        q = (V * lam) @ V.T
        if i == 3:
            q[m // 2, m // 2] = np.nan
        qs.append((q + q.T) / 2)
    return torch.tensor(np.stack(qs), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,block", [(64, 64), (150, 64)])
def test_plain_flag_is_set_where_cholesky_ex_fails(dtype, m, block):
    from online_gp_torch.ops.cuda_chol import blocked_cholesky_ex, blocked_cholesky_plain_ex

    q = _indefinite_batch(m, dtype)
    _, want = torch.linalg.cholesky_ex(q)
    L, info = blocked_cholesky_plain_ex(q, block)
    assert info.dtype == torch.int32 and info.shape == (5,)
    assert torch.equal(info != 0, want != 0)
    assert torch.equal(info != 0, torch.tensor([False, True, False, True, True]))
    # the CPU entry is the plain version; the flag leaves the factor as it was
    L2, info2 = blocked_cholesky_ex(q, block)
    torch.testing.assert_close(L2, L, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(info, info2)
    good = info == 0
    np.testing.assert_allclose(L[good].numpy(), np.linalg.cholesky(q[good].numpy().astype(np.float64)),
                               atol=2e-5, rtol=1e-4)


def _lower_all_nan(t):
    rows, cols = torch.tril_indices(t.shape[-1], t.shape[-1])
    return bool(torch.isnan(t[..., rows, cols]).all())


def test_spd_cholesky_gives_nan_where_cholesky_does():
    from online_gp_torch.ops.chol import cholesky, spd_cholesky

    q = _indefinite_batch(40, torch.float64)
    got, want = spd_cholesky(q), cholesky(q)
    failed = torch.tensor([False, True, False, True, True])
    assert _lower_all_nan(got[failed]) and _lower_all_nan(want[failed])
    assert torch.equal(got[~failed], want[~failed])


class _FakeCudaTensor:
    """Stands in for a CUDA tensor where there is no card: the route reads
    only these attributes."""

    def __init__(self, dtype=torch.float32, requires_grad=False):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype
        self.requires_grad = requires_grad


def test_spd_cholesky_routes_by_the_tensor(monkeypatch):
    """K6 only for CUDA float32 tensors that need no grad; everything else
    goes to cholesky. Checked without a card: on meta tensors and on
    stand-ins for CUDA tensors, with both factorizations recorded."""
    from online_gp_torch.ops import chol

    meta = torch.empty((2, 8, 8), device="meta")
    calls = []
    eye = torch.eye(3).expand(2, 3, 3)

    def fake_k6(mat):
        calls.append("k6")
        return eye, torch.tensor([0, 1], dtype=torch.int32)

    def fake_cholesky(mat):
        calls.append("cholesky")
        return eye

    monkeypatch.setattr(chol, "blocked_cholesky_ex", fake_k6)
    monkeypatch.setattr(chol, "cholesky", fake_cholesky)
    got = chol.spd_cholesky(_FakeCudaTensor())
    assert calls == ["k6"]
    assert torch.equal(got[0], torch.eye(3)) and _lower_all_nan(got[1])
    others = (_FakeCudaTensor(requires_grad=True), _FakeCudaTensor(dtype=torch.float64),
              _FakeCudaTensor(dtype=torch.float16), meta, torch.eye(3))
    for other in others:
        chol.spd_cholesky(other)
    assert calls == ["k6"] + ["cholesky"] * len(others)


def test_k6_entries_raise_on_tensors_they_do_not_take():
    from online_gp_torch.ops.cuda_chol import blocked_cholesky_ex

    with pytest.raises(TypeError, match="blocked_cholesky_plain_ex"):
        blocked_cholesky_ex(torch.empty((1, 8, 8), device="meta"))
