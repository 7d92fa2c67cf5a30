"""The port's spectral mixture kernel against the JAX package, float64: the
kernel matrix, the grid's dense K_uu (a sum of Kronecker chains), the
Toeplitz-FFT and Kronecker K_uu products, batched params, the default and
the data-driven init (and the dense wrapper's use of it), and
``make_kernel``'s names. The JAX oracle is
tests/ops/test_spectral_mixture.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels import grid_kernel as jgk
from online_gp_tpu.kernels.base import make_kernel as jmake
from online_gp_tpu.kernels.spectral_mixture import SpectralMixtureKernel as JSM
from online_gp_tpu.kernels.spectral_mixture import sm_init_from_data as j_init
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.kernels import grid_kernel as tgk
from online_gp_torch.kernels.base import make_kernel
from online_gp_torch.kernels.spectral_mixture import SpectralMixtureKernel, sm_init_from_data

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over 64-element ops cost several
    times what they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(want, got, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.max(np.abs(want)))


def _params(Q, D, batch=(), seed=0):
    """JAX's init, moved off its even spread so that components differ."""
    rng = np.random.default_rng(seed)
    jp = JSM(Q).init_params(D, batch_shape=batch, dtype=jnp.float64)
    jp = {k: v + 0.3 * jnp.asarray(rng.normal(size=v.shape)) for k, v in jp.items()}
    return jp, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _grid(bounds, size):
    jg = JGrid.create(bounds, size, dtype=jnp.float64)
    return jg, convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")


@pytest.mark.parametrize("batch", [(), (3,)])
def test_init_params_match_jax(batch):
    jp = JSM(3).init_params(2, batch_shape=batch, lengthscale=0.4, outputscale=1.7, dtype=jnp.float64)
    tp = SpectralMixtureKernel(3).init_params(2, batch, lengthscale=0.4, outputscale=1.7, dtype=torch.float64,
                                              device="cpu")
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tuple(tp[key].shape) == tuple(jp[key].shape)
        _close(jp[key], tp[key])


def test_matrix_matches_jax():
    jp, tp = _params(3, 2)
    rng = np.random.default_rng(1)
    x1, x2 = rng.uniform(-1, 1, (5, 2)), rng.uniform(-1, 1, (4, 2))
    _close(JSM(3).matrix(jp, jnp.asarray(x1), jnp.asarray(x2)),
           SpectralMixtureKernel(3).matrix(tp, torch.tensor(x1), torch.tensor(x2)))


def test_grid_dense_matches_jax_and_the_matrix():
    jp, tp = _params(3, 2)
    jg, tg = _grid([(-1.0, 1.0), (-0.5, 0.8)], 7)
    Kuu = tgk.grid_kuu_dense(SpectralMixtureKernel(3), tp, tg)
    _close(jgk.grid_kuu_dense(JSM(3), jp, jg), Kuu)
    pts = np.asarray(jg.full_points())
    _close(SpectralMixtureKernel(3).matrix(tp, torch.tensor(pts), torch.tensor(pts)).numpy(), Kuu, 1e-9)


@pytest.mark.parametrize("use_toeplitz", [True, False])
def test_grid_mvm_matches_jax(use_toeplitz):
    jp, tp = _params(2, 2, seed=2)
    jg, tg = _grid([(-1.0, 1.0)] * 2, 8)
    x = np.random.default_rng(2).normal(size=(tg.num_points, 3))
    _close(jgk.grid_kuu_mvm(JSM(2), jp, jg, jnp.asarray(x), use_toeplitz=use_toeplitz),
           tgk.grid_kuu_mvm(SpectralMixtureKernel(2), tp, tg, torch.tensor(x), use_toeplitz=use_toeplitz))
    dense = tgk.grid_kuu_dense(SpectralMixtureKernel(2), tp, tg) @ torch.tensor(x)
    _close(dense.numpy(), tgk.grid_kuu_mvm(SpectralMixtureKernel(2), tp, tg, torch.tensor(x), use_toeplitz=use_toeplitz))


def test_batched_params_match_jax():
    jp, tp = _params(2, 1, batch=(3,), seed=3)
    jg, tg = _grid([(-1.0, 1.0)], 6)
    Kuu = tgk.grid_kuu_dense(SpectralMixtureKernel(2), tp, tg)
    assert Kuu.shape == (3, 6, 6)
    _close(jgk.grid_kuu_dense(JSM(2), jp, jg), Kuu)
    x = np.random.default_rng(3).normal(size=(3, 6, 2))
    got = tgk.grid_kuu_mvm(SpectralMixtureKernel(2), tp, tg, torch.tensor(x), use_toeplitz=True)
    for b in range(3):
        jpb = jax.tree_util.tree_map(lambda a: a[b], jp)
        _close(jgk.grid_kuu_mvm(JSM(2), jpb, jg, jnp.asarray(x[b]), use_toeplitz=True), got[b])


@pytest.mark.parametrize("batch", [(), (2,)])
def test_sm_init_from_data_matches_jax(batch):
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(-1, 1, (160, 2)), axis=0)
    y = np.sin(2 * np.pi * 2.0 * x[:, :1]) + 0.5 * np.sin(2 * np.pi * 5.0 * x[:, 1:]) + 0.05 * rng.normal(size=(160, 1))
    jp = j_init(JSM(3), jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), batch)
    tp = sm_init_from_data(SpectralMixtureKernel(3), torch.tensor(x), torch.tensor(y), batch, dtype=torch.float64,
                           device="cpu")
    for key in jp:
        assert tuple(tp[key].shape) == tuple(jp[key].shape)
        _close(jp[key], tp[key])
    # the same from numpy arrays and through the kernel's hook
    hook = SpectralMixtureKernel(3).data_init_params(x, y, batch, dtype=torch.float64, device="cpu")
    for key in jp:
        _close(jp[key], hook[key])


@pytest.mark.parametrize("name,q", [("sm2", 2), ("sm3", 3), ("sm4", 4), ("spectral_mixture", 3)])
def test_make_kernel_names(name, q):
    k = make_kernel(name)
    assert isinstance(k, SpectralMixtureKernel) and k.num_components == q == jmake(name).num_components


def test_dense_wrapper_starts_a_spectral_mixture_from_the_data():
    """OnlineSKIRegression with kernel="sm2" takes its starting hypers from
    the init data, as the JAX wrapper does (float32 params in the port)."""
    from online_gp_tpu.api import IdentityStem as JIdentity
    from online_gp_tpu.api import OnlineSKIRegression as JRegression
    from online_gp_torch.api import IdentityStem, OnlineSKIRegression

    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(-1, 1, (80, 1)), axis=0)
    y = np.sin(2 * np.pi * 3.0 * x) + 0.05 * rng.normal(size=(80, 1))
    jr = JRegression(JIdentity(1), x, y, grid_size=32, kernel="sm2")
    tr = OnlineSKIRegression(IdentityStem(1), x, y, grid_size=32, kernel="sm2", device="cpu")
    for key in ("raw_sm_weights", "raw_sm_means", "raw_sm_scales"):
        assert tr.params["kernel"][key].dtype == torch.float32 and tr.params["kernel"][key].requires_grad
        _close(np.asarray(jr.params["kernel"][key]), tr.params["kernel"][key], 1e-6)
    mean, var = tr.predict(x[:8])
    assert mean.shape == var.shape == (8, 1) and bool(torch.isfinite(mean).all())
