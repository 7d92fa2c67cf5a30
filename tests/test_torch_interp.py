"""online_gp_torch grid, interpolation and grid-kernel ops against the JAX
package, on the same numpy-seeded inputs at float64 (single ops: 1e-9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels import base as jbase
from online_gp_tpu.kernels import grid_kernel as jgk
from online_gp_tpu.ops import grid as jgrid
from online_gp_tpu.ops import interp as jinterp
from online_gp_tpu.ops import kron as jkron
from online_gp_torch.convert import grid_from_numpy, params_from_numpy
from online_gp_torch.kernels import base as tbase
from online_gp_torch.kernels import grid_kernel as tgk
from online_gp_torch.ops import grid as tgrid
from online_gp_torch.ops import interp as tinterp
from online_gp_torch.ops import kron as tkron

TOL = 1e-9


def _grids(bounds, size):
    jg = jgrid.Grid.create(bounds, size, dtype=jnp.float64)
    tg = tgrid.Grid.create(bounds, size, dtype=torch.float64, device="cpu")
    return jg, tg


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("sizes", [8, (6, 9), (6, 7, 8)])
def test_grid_matches(sizes):
    ndim = 3 if isinstance(sizes, tuple) and len(sizes) == 3 else 2
    bounds = [(-1.1, 1.1), (-0.5, 2.0), (0.0, 1.0)][:ndim]
    jg, tg = _grids(bounds, sizes)
    assert tg.sizes == jg.sizes
    assert tg.num_points == jg.num_points
    assert tg.strides == jg.strides
    _close(jg.mins, tg.mins)
    _close(jg.spacings, tg.spacings)
    for d in range(ndim):
        _close(jg.points_1d(d), tg.points_1d(d))
    cg = grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    assert cg.sizes == jg.sizes
    _close(jg.points_1d(0), cg.points_1d(0))


@pytest.mark.parametrize("ndim,size", [(1, 10), (2, 8), (3, 6)])
def test_interp_coeffs_matches_with_clamped_points(ndim, size):
    rng = np.random.default_rng(ndim)
    jg, tg = _grids([(-1.0, 1.0)] * ndim, size)
    # the grid reaches 2 spacings past the bounds; +-3.5 lies beyond it, so
    # the stencil clamp to [1, m-3] is exercised on both sides
    x = rng.uniform(-3.5, 3.5, (40, ndim))
    x[0] = 3.5
    x[1] = -3.5
    ji, jw = jinterp.interp_coeffs(jg, jnp.asarray(x, jnp.float64))
    ti, tw = tinterp.interp_coeffs(tg, torch.tensor(x))
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(jw, tw)
    assert ti.min() >= 0 and ti.max() < tg.num_points


def test_interp_ops_match_with_duplicate_indices():
    rng = np.random.default_rng(1)
    m, n, P, k = 12, 9, 4, 3
    idx = rng.integers(0, 4, (n, P))  # few distinct values: many duplicates
    idx[0] = [2, 2, 2, 5]
    w = rng.normal(size=(n, P))
    cache = rng.normal(size=(2, m, k))
    v = rng.normal(size=(n, k))
    ji, jw_ = jnp.asarray(idx, jnp.int32), jnp.asarray(w, jnp.float64)
    ti, tw_ = torch.tensor(idx), torch.tensor(w)
    _close(jinterp.interp_matvec(ji, jw_, jnp.asarray(cache)), tinterp.interp_matvec(ti, tw_, torch.tensor(cache)))
    _close(jinterp.dense_w(ji, jw_, m), tinterp.dense_w(ti, tw_, m))
    _close(jinterp._densify_rows(ji, jw_, m), tinterp._densify_rows(ti, tw_, m))
    _close(jinterp.wt_matvec(ji, jw_, jnp.asarray(v), m), tinterp.wt_matvec(ti, tw_, torch.tensor(v), m))
    # the duplicate stencil entries are summed
    assert float(tinterp.dense_w(ti, tw_, m)[2, 0]) == pytest.approx(w[0, :3].sum(), abs=1e-12)


def test_gather_predict_matches():
    rng = np.random.default_rng(2)
    jg, tg = _grids([(-1.0, 1.0)] * 2, 8)
    m = tg.num_points
    x = rng.uniform(-1.2, 1.2, (25, 2))
    G = rng.normal(size=(2, m, m))
    cov = G @ np.swapaxes(G, -1, -2) / m
    mean = rng.normal(size=(2, m, 1))
    ji, jw_ = jinterp.interp_coeffs(jg, jnp.asarray(x))
    ti, tw_ = tinterp.interp_coeffs(tg, torch.tensor(x))
    jm, jv = jinterp.gather_predict(ji, jw_, jnp.asarray(mean), jnp.asarray(cov))
    tm, tv = tinterp.gather_predict(ti, tw_, torch.tensor(mean), torch.tensor(cov))
    _close(jm, tm)
    _close(jv, tv)
    tm2, tv2 = tinterp.gather_predict(ti, tw_, torch.tensor(mean), None)
    assert tv2 is None
    _close(jm, tm2)


def test_kron_dense_matches_batched():
    rng = np.random.default_rng(3)
    fs = [rng.normal(size=(2, 3, 3)), rng.normal(size=(4, 4)), rng.normal(size=(1, 2, 2))]
    _close(jkron.kron_dense([jnp.asarray(f) for f in fs]), tkron.kron_dense([torch.tensor(f) for f in fs]))


@pytest.mark.parametrize("bounded", [False, True])
def test_grid_kuu_dense_and_kernel_match(bounded):
    rng = np.random.default_rng(4)
    jk, tk = jbase.RBFKernel(), tbase.RBFKernel()
    if bounded:
        jk.constrain(lengthscale_bounds=(0.05, 4.0), outputscale_bounds=(0.1, 3.0))
        tk.constrain(lengthscale_bounds=(0.05, 4.0), outputscale_bounds=(0.1, 3.0))
    jp = jk.init_params(2, (2,), lengthscale=0.4, outputscale=1.7, dtype=jnp.float64)
    jp = {key: val + jnp.asarray(rng.normal(scale=0.2, size=val.shape)) for key, val in jp.items()}
    tp = params_from_numpy({key: np.asarray(val) for key, val in jp.items()}, device="cpu")
    tp0 = tk.init_params(2, (2,), lengthscale=0.4, outputscale=1.7, dtype=torch.float64, device="cpu")
    jp0 = jk.init_params(2, (2,), lengthscale=0.4, outputscale=1.7, dtype=jnp.float64)
    _close(jp0["raw_lengthscale"], tp0["raw_lengthscale"])
    _close(jp0["raw_outputscale"], tp0["raw_outputscale"])
    jg, tg = _grids([(-1.1, 1.1), (0.0, 2.0)], (7, 8))
    _close(jgk.grid_kuu_dense(jk, jp, jg), tgk.grid_kuu_dense(tk, tp, tg))
    x1, x2 = rng.normal(size=(5, 2)), rng.normal(size=(4, 2))
    _close(jk.matrix(jp, jnp.asarray(x1), jnp.asarray(x2)), tk.matrix(tp, torch.tensor(x1), torch.tensor(x2)))
    g = tg.points_1d(1)
    _close(jk.factor_col(jp, 1, jg.points_1d(1), True), tk.factor_col(tp, 1, g, True))
