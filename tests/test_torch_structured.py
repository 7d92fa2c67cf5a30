"""The port's structured K_uu products against the JAX package, float64:
``toeplitz_mvm``/``sym_toeplitz_dense``, ``kron_mvm`` and ``grid_kuu_mvm``
(Toeplitz and Kronecker, single kernels and the spectral mixture), to 1e-12
relative to each output's largest entry. The JAX oracle is
tests/ops/test_structured.py; the port takes batched params where JAX
vmaps one output's params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels import grid_kernel as jgk
from online_gp_tpu.kernels.base import MaternKernel as JMatern
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.kernels.spectral_mixture import SpectralMixtureKernel as JSM
from online_gp_tpu.ops import kron as jkron
from online_gp_tpu.ops import toeplitz as jtoep
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.kernels import grid_kernel as tgk
from online_gp_torch.kernels.base import MaternKernel, RBFKernel
from online_gp_torch.kernels.spectral_mixture import SpectralMixtureKernel
from online_gp_torch.ops import kron as tkron
from online_gp_torch.ops import toeplitz as ttoep

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


def _close(want, got):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.max(np.abs(want)))


def test_toeplitz_mvm_and_dense_match_jax():
    rng = np.random.default_rng(0)
    col = np.exp(-0.5 * np.arange(17.0) ** 2 / 9.0)
    x = rng.normal(size=(17, 3))
    _close(jtoep.toeplitz_mvm(jnp.asarray(col), jnp.asarray(x)), ttoep.toeplitz_mvm(torch.tensor(col), torch.tensor(x)))
    _close(jtoep.sym_toeplitz_dense(jnp.asarray(col)), ttoep.sym_toeplitz_dense(torch.tensor(col)))
    # batched columns against batched right-hand sides
    cols = np.stack([col, col[::-1].copy(), 0.5 * col])
    xs = rng.normal(size=(3, 17, 2))
    want = np.stack([np.asarray(jtoep.toeplitz_mvm(jnp.asarray(c), jnp.asarray(v))) for c, v in zip(cols, xs)])
    _close(want, ttoep.toeplitz_mvm(torch.tensor(cols), torch.tensor(xs)))


def test_kron_mvm_matches_jax():
    rng = np.random.default_rng(1)
    fs = [rng.normal(size=(s, s)) for s in (4, 5, 3)]
    x = rng.normal(size=(60, 2))
    _close(jkron.kron_mvm([jnp.asarray(f) for f in fs], jnp.asarray(x)),
           tkron.kron_mvm([torch.tensor(f) for f in fs], torch.tensor(x)))
    # batched factors against batched right-hand sides
    fb = [rng.normal(size=(2, s, s)) for s in (4, 5)]
    xb = rng.normal(size=(2, 20, 3))
    want = np.stack([np.asarray(jkron.kron_mvm([jnp.asarray(f[b]) for f in fb], jnp.asarray(xb[b]))) for b in range(2)])
    _close(want, tkron.kron_mvm([torch.tensor(f) for f in fb], torch.tensor(xb)))


def _grids(sizes=(7, 6)):
    jg = JGrid.create([(-1.0, 1.0), (0.0, 2.0)], sizes, dtype=jnp.float64)
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    return jg, tg


KERNELS = {
    "rbf": (JRBF, RBFKernel, {}),
    "matern32": (lambda: JMatern(1.5), lambda: MaternKernel(1.5), {}),
    "sm3": (lambda: JSM(3), lambda: SpectralMixtureKernel(3), {}),
}


def _params(jk, B, rng):
    jp = jk.init_params(2, (B,), dtype=jnp.float64)
    # distinct per-output hypers
    return {k: v + 0.2 * jnp.asarray(rng.normal(size=v.shape)) for k, v in jp.items()}


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("use_toeplitz", [True, False])
def test_grid_kuu_mvm_matches_jax(name, use_toeplitz):
    """B = 3 outputs: JAX per output (unbatched params, as its vmapped
    callers), the port in one batch; and the dense K_uu."""
    rng = np.random.default_rng(2)
    jmake, tmake, _ = KERNELS[name]
    jk, tk = jmake(), tmake()
    jg, tg = _grids()
    B, m = 3, jg.num_points
    jp = _params(jk, B, rng)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = rng.normal(size=(B, m, 4))
    got = tgk.grid_kuu_mvm(tk, tp, tg, torch.tensor(x), use_toeplitz=use_toeplitz)
    for b in range(B):
        jpb = jax.tree_util.tree_map(lambda a: a[b], jp)
        _close(jgk.grid_kuu_mvm(jk, jpb, jg, jnp.asarray(x[b]), use_toeplitz=use_toeplitz), got[b])
    _close(jgk.grid_kuu_dense(jk, jp, jg), tgk.grid_kuu_dense(tk, tp, tg))
    # unbatched params against an unbatched right-hand side, as in JAX
    jp0 = jax.tree_util.tree_map(lambda a: a[0], jp)
    tp0 = {k: v[0] for k, v in tp.items()}
    _close(jgk.grid_kuu_mvm(jk, jp0, jg, jnp.asarray(x[0]), use_toeplitz=use_toeplitz),
           tgk.grid_kuu_mvm(tk, tp0, tg, torch.tensor(x[0]), use_toeplitz=use_toeplitz))


def test_grid_kuu_toeplitz_equals_dense_product():
    """The port's own structured products against its dense K_uu (the JAX
    test_grid_kuu_mvm_paths_agree, at 1e-12 in float64)."""
    rng = np.random.default_rng(3)
    _, tg = _grids((9, 8))
    tk = RBFKernel()
    tp = tk.init_params(2, (2,), lengthscale=0.5, outputscale=2.0, dtype=torch.float64, device="cpu")
    x = torch.tensor(rng.normal(size=(2, tg.num_points, 3)))
    dense = tgk.grid_kuu_dense(tk, tp, tg) @ x
    for use_toeplitz in (True, False):
        _close(dense.numpy(), tgk.grid_kuu_mvm(tk, tp, tg, x, use_toeplitz=use_toeplitz))
