"""The port's rank-capped large-grid WISKI core against the JAX package,
float64: init and conditioning, with and without params (Frobenius and
kernel-aware compression), at n below and above the root buffer so that
compression fires; then the MLL with its gradient and predict (mean and
variance); then the batched ``*_b`` variants at B = 3 (one batch in the
port, JAX's vmap).

The compression keeps the top eigenvectors of a Gram, which are fixed only
up to sign and rotation within ties, so roots are compared as L L^T (1e-9
relative to its largest entry); the data gives a clear gap at the kept
rank (checked). Everything else is held to 1e-8. The oracles are
tests/models/test_wiski_lowrank.py and test_lowrank_batched.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.config import SolverConfig as JConfig
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import wiski_lowrank as jl
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import wiski_lowrank as tl

TOL = 1e-8
ROOT_TOL = 1e-9
RANK, K_BUF = 8, 24


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
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.max(np.abs(want)), 1e-300))


def _close_state(js, ts):
    jr = np.asarray(js.root)
    _close(jr @ np.swapaxes(jr, -1, -2), ts.root @ ts.root.mT, ROOT_TOL)
    _close(js.wty, ts.wty)
    _close(js.ydy, ts.ydy)
    _close(js.d_logdet, ts.d_logdet)
    assert set(np.unique(np.asarray(js.used))) == {ts.used}
    assert set(np.unique(np.asarray(js.num_data))) == {ts.num_data}


@functools.lru_cache(maxsize=None)
def _models(dims, use_toeplitz=True):
    jg = JGrid.create([(-1.1, 1.1)] * dims, 64 if dims == 1 else 10, dtype=jnp.float64)
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    kw = dict(rank=RANK, buffer_cols=K_BUF, learn_additional_noise=True, use_toeplitz=use_toeplitz)
    return jl.WiskiLowRankModel(JRBF(), jg, **kw), tl.WiskiLowRankModel(RBFKernel(), tg, **kw)


def _params(jm, B=None):
    dims = jm.grid.ndim
    if B is None:
        jp = jm.init_params(dims, dtype=jnp.float64)
        jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] - 0.4
        jp["raw_second_noise"] = jp["raw_second_noise"] - 0.5
    else:
        jp = jl.lowrank_init_params_batched(jm, dims, B, dtype=jnp.float64)
        jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] - 0.4 + 0.2 * jnp.arange(B)[:, None]
        jp["raw_second_noise"] = 0.1 * jnp.arange(B, dtype=jnp.float64) - 0.5
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _data(n, dims, B=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, dims))
    y = np.stack([np.sin((b + 3) * x[:, 0]) + 0.1 * rng.normal(size=n) for b in range(B)], axis=-1)
    return x, y, rng.uniform(0.5, 1.5, (n, B))


@functools.lru_cache(maxsize=None)
def _jit(name):
    """The JAX function, jitted with the model static (eager JAX compiles
    one program per op)."""
    return jax.jit(getattr(jl, name), static_argnums=0)


@functools.lru_cache(maxsize=None)
def _jit_value_and_grad(name, skip):
    cfg = JConfig(skip_logdet_forward=skip)
    fn = getattr(jl, name)
    return jax.jit(jax.value_and_grad(lambda p, m, s: jnp.sum(fn(m, p, s, cfg))), static_argnums=1)


def _kept_rank_gap(root, params, tm):
    """Relative gap between the eigenvalues kept and dropped by the next
    compression of ``root`` (the Gram it takes)."""
    with torch.no_grad():
        gram = root.mT @ (root if params is None else tl._kuu_mvm(tm, params, root))
        ev = torch.linalg.eigvalsh(0.5 * (gram + gram.mT))
    kept, dropped = ev[..., K_BUF - RANK], ev[..., K_BUF - RANK - 1]
    return float(torch.min((kept - dropped) / kept))


@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("aware", [False, True])
def test_lowrank_core_matches_jax(dims, aware):
    jm, tm = _models(dims)
    jp, tp = _params(jm)
    jpp, tpp = (jp, tp) if aware else (None, None)
    x, y, nz = _data(56, dims)
    J, T = jnp.asarray, torch.tensor
    # below the buffer: exact
    js = _jit("wiski_lowrank_init")(jm, J(x[:16]), J(y[:16]), J(nz[:16]), params=jpp)
    ts = tl.wiski_lowrank_init(tm, T(x[:16]), T(y[:16]), T(nz[:16]), params=tpp)
    _close_state(js, ts)
    assert ts.used == 16
    # 16 more columns do not fit: compression fires
    assert _kept_rank_gap(ts.root, tpp, tm) > 1e-3
    js = _jit("wiski_lowrank_condition")(jm, js, J(x[16:32]), J(y[16:32]), J(nz[16:32]), jpp)
    ts = tl.wiski_lowrank_condition(tm, ts, T(x[16:32]), T(y[16:32]), T(nz[16:32]), tpp)
    _close_state(js, ts)
    assert ts.used == RANK + 16
    # single points, then an init above the buffer (compressing inside)
    for i in range(32, 36):
        js = _jit("wiski_lowrank_condition")(jm, js, J(x[i : i + 1]), J(y[i : i + 1]), J(nz[i : i + 1]), jpp)
        ts = tl.wiski_lowrank_condition(tm, ts, T(x[i : i + 1]), T(y[i : i + 1]), T(nz[i : i + 1]), tpp)
    _close_state(js, ts)
    js2 = _jit("wiski_lowrank_init")(jm, J(x), J(y), J(nz), params=jpp)
    ts2 = tl.wiski_lowrank_init(tm, T(x), T(y), T(nz), params=tpp)
    _close_state(js2, ts2)

    # the MLL (with and without the log-det), its gradient, and predict
    leaves = [tp["kernel"]["raw_lengthscale"], tp["kernel"]["raw_outputscale"], tp["raw_second_noise"]]
    for t in leaves:
        t.requires_grad_(True)
    for skip in (False, True):
        jval, jgrad = _jit_value_and_grad("wiski_lowrank_mll", skip)(jp, jm, js)
        val = tl.wiski_lowrank_mll(tm, tp, ts, SolverConfig(skip_logdet_forward=skip))
        _close(jval, val)
        jleaves = [jgrad["kernel"]["raw_lengthscale"], jgrad["kernel"]["raw_outputscale"], jgrad["raw_second_noise"]]
        for a, b in zip(jleaves, torch.autograd.grad(val, leaves)):
            _close(a, b)
    xt = np.random.default_rng(9).uniform(-1, 1, (17, dims))
    jmean, jvar = _jit("wiski_lowrank_predict")(jm, jp, js, J(xt))
    with torch.no_grad():
        tmean, tvar = tl.wiski_lowrank_predict(tm, tp, ts, T(xt))
    _close(jmean, tmean)
    _close(jvar, tvar)
    with torch.no_grad():
        mean_only, none = tl.wiski_lowrank_predict(tm, tp, ts, T(xt), SolverConfig(skip_posterior_variances=True))
    assert none is None
    _close(tmean, mean_only)


def test_lowrank_dense_kuu_products_match_jax():
    """use_toeplitz=False: Kronecker products of dense factors."""
    jm, tm = _models(2, use_toeplitz=False)
    jp, tp = _params(jm)
    x, y, nz = _data(40, 2, seed=1)
    js = _jit("wiski_lowrank_init")(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(nz), params=jp)
    ts = tl.wiski_lowrank_init(tm, torch.tensor(x), torch.tensor(y), torch.tensor(nz), params=tp)
    _close_state(js, ts)
    _close(_jit("wiski_lowrank_mll")(jm, jp, js), tl.wiski_lowrank_mll(tm, tp, ts))


@pytest.mark.parametrize("aware", [False, True])
def test_lowrank_batched_matches_jax(aware):
    B = 3
    jm, tm = _models(1)
    jp, tp = _params(jm, B)
    jpp, tpp = (jp, tp) if aware else (None, None)
    x, y, nz = _data(44, 1, B, seed=2)
    J, T = jnp.asarray, torch.tensor
    js = _jit("wiski_lowrank_init_b")(jm, J(x[:40]), J(y[:40]), J(nz[:40]), params=jpp)
    ts = tl.wiski_lowrank_init_b(tm, T(x[:40]), T(y[:40]), T(nz[:40]), params=tpp)
    assert ts.root.shape == (B, 64, K_BUF)
    _close_state(js, ts)
    js = _jit("wiski_lowrank_condition_b")(jm, js, J(x[40:]), J(y[40:]), J(nz[40:]), jpp)
    ts = tl.wiski_lowrank_condition_b(tm, ts, T(x[40:]), T(y[40:]), T(nz[40:]), tpp)
    _close_state(js, ts)
    leaves = [tp["kernel"]["raw_lengthscale"], tp["kernel"]["raw_outputscale"], tp["raw_second_noise"]]
    for t in leaves:
        t.requires_grad_(True)
    jval, jgrad = _jit_value_and_grad("wiski_lowrank_mll_b", False)(jp, jm, js)
    per_output = tl.wiski_lowrank_mll_b(tm, tp, ts)
    assert per_output.shape == (B,)
    _close(_jit("wiski_lowrank_mll_b")(jm, jp, js), per_output)
    _close(jval, torch.sum(per_output))
    jleaves = [jgrad["kernel"]["raw_lengthscale"], jgrad["kernel"]["raw_outputscale"], jgrad["raw_second_noise"]]
    for a, b in zip(jleaves, torch.autograd.grad(torch.sum(per_output), leaves)):
        _close(a, b)
    xt = np.linspace(-0.9, 0.9, 16)[:, None]
    jmean, jvar = _jit("wiski_lowrank_predict_b")(jm, jp, js, J(xt))
    with torch.no_grad():
        tmean, tvar = tl.wiski_lowrank_predict_b(tm, tp, ts, T(xt))
    assert tmean.shape == (B, 16) and tvar.shape == (B, 16)
    _close(jmean, tmean)
    _close(jvar, tvar)


def test_lowrank_rejects_buffer_not_exceeding_rank():
    _, tm = _models(1)
    x, y, nz = _data(8, 1)
    with pytest.raises(ValueError, match="must exceed rank"):
        tl.wiski_lowrank_init(tm._replace(buffer_cols=RANK), torch.tensor(x), torch.tensor(y), torch.tensor(nz))


def test_lowrank_state_from_numpy_round_trip():
    jm, tm = _models(1)
    x, y, nz = _data(30, 1, 2)
    js = _jit("wiski_lowrank_init_b")(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(nz))
    a = np.asarray
    ts = convert.lowrank_state_from_numpy(a(js.wty), a(js.ydy), a(js.root), a(js.used), a(js.d_logdet),
                                          a(js.num_data), device="cpu")
    assert ts.used == int(js.used[0]) and ts.num_data == 30
    assert torch.equal(ts.root, torch.tensor(a(js.root)))
