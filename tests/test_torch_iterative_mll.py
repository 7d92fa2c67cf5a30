"""The port's iterative (m > max_cholesky_size) WISKI MLL and its rank-capped
predictive roots against the JAX package, float64.

Setup of tests/models/test_solver_config.py: a 2-D 8 x 8 grid (m = 64),
RBF, learned second noise, 48 points, ``max_cholesky_size=32`` and CG to
1e-12. The JAX state and params are carried across by ``convert``.

- With JAX's own probes for each output (``fold_in(key, b)``; ``split``
  then ``rademacher`` for SLQ; ``rademacher(fold_in(key_b, 1))`` for
  Hutchinson), the value and the gradient of every leaf agree with JAX to
  1e-8 relative, for B = 1 and 3, Toeplitz on and off.
- With the port's own generator, the value lies within rtol 0.15 of the
  dense MLL and the gradient's cosine with the dense one exceeds 0.97 (the
  bound of JAX's test_iterative_mll_tracks_dense).
- ``fast_pred_var`` below full rank (LOVE), ``wiski_predict_root`` and
  ``fast_pred_samples`` agree with JAX to 1e-8, with the Lanczos start
  vector set to JAX's (``normal(PRNGKey(0))``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.config import SolverConfig as JConfig
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import wiski as tw

TOL = 1e-8
ITER = dict(max_cholesky_size=32, max_cg_iterations=256, cg_tolerance=1e-12)


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


@functools.lru_cache(maxsize=None)
def _setup(B):
    jg = JGrid.create([(-1.1, 1.1)] * 2, 8, dtype=jnp.float64)
    jm = jw.WiskiModel(JRBF(), jg, num_outputs=B, learn_additional_noise=True)
    jp = jm.init_params(2, dtype=jnp.float64)
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] - 0.1 * jnp.arange(B)[:, None]
    jp["raw_second_noise"] = jp["raw_second_noise"] + 0.2
    x = jax.random.uniform(jax.random.PRNGKey(0), (48, 2), minval=-1, maxval=1, dtype=jnp.float64)
    y = jnp.sin(3 * x[:, :1]) * jnp.linspace(1.0, 0.5, B)[None]
    js = jax.jit(jw.wiski_init, static_argnums=0)(jm, x, y, 0.1 * jnp.ones_like(y))
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    tm = tw.WiskiModel(RBFKernel(), tg, num_outputs=B, learn_additional_noise=True)
    a = lambda v: None if v is None else np.asarray(v)
    ts = convert.state_from_numpy(a(js.wty), a(js.ydy), a(js.roots.mat), a(js.roots.root), a(js.roots.inv_root),
                                  a(js.d_logdet), a(js.num_data), device="cpu")
    return jm, tm, jp, js, ts


def _tparams(jp):
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    leaves = [tp["kernel"]["raw_lengthscale"], tp["kernel"]["raw_outputscale"], tp["raw_second_noise"]]
    for t in leaves:
        t.requires_grad_(True)
    return tp, leaves


def _jleaves(g):
    return [g["kernel"]["raw_lengthscale"], g["kernel"]["raw_outputscale"], g["raw_second_noise"]]


def jax_probes(key, B, m, num_probes=tw.NUM_PROBES):
    """The probes the JAX package's _mll_inner_iterative draws from key."""
    slq, hutch = [], []
    for b in range(B):
        kb = jax.random.fold_in(key, b)
        slq.append([np.asarray(jax.random.rademacher(k, (m,), dtype=jnp.float64))
                    for k in jax.random.split(kb, num_probes)])
        hutch.append(np.asarray(jax.random.rademacher(jax.random.fold_in(kb, 1), (m, num_probes), dtype=jnp.float64)))
    return tw.MllProbes(torch.tensor(np.asarray(slq)), torch.tensor(np.asarray(hutch)))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(B, use_toeplitz, skip_logdet):
    jm, _, _, js, _ = _setup(B)
    cfg = JConfig(**ITER, use_toeplitz=use_toeplitz, skip_logdet_forward=skip_logdet)
    return jax.jit(jax.value_and_grad(lambda p, key: jnp.sum(jw.wiski_mll(jm, p, js, cfg, slq_key=key))))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("use_toeplitz", [False, True])
def test_iterative_mll_matches_jax_with_its_probes(B, use_toeplitz):
    jm, tm, jp, js, ts = _setup(B)
    key = jax.random.PRNGKey(3)
    jval, jgrad = _jax_value_and_grad(B, use_toeplitz, False)(jp, key)
    tp, leaves = _tparams(jp)
    cfg = SolverConfig(**ITER, use_toeplitz=use_toeplitz)
    per_output = tw.wiski_mll(tm, tp, ts, cfg, probes=jax_probes(key, B, 64))
    assert per_output.shape == (B,)
    val = torch.sum(per_output)
    _close(jval, val)
    for jg_, g in zip(_jleaves(jgrad), torch.autograd.grad(val, leaves)):
        _close(jg_, g)


def test_iterative_mll_skip_logdet_matches_jax():
    """The hyper step's objective: log|Q| out of the value, its surrogate
    gradient kept."""
    jm, tm, jp, js, ts = _setup(1)
    key = jax.random.PRNGKey(4)
    jval, jgrad = _jax_value_and_grad(1, True, True)(jp, key)
    tp, leaves = _tparams(jp)
    cfg = SolverConfig(**ITER, use_toeplitz=True, skip_logdet_forward=True)
    val = torch.sum(tw.wiski_mll(tm, tp, ts, cfg, probes=jax_probes(key, 1, 64)))
    _close(jval, val)
    for jg_, g in zip(_jleaves(jgrad), torch.autograd.grad(val, leaves)):
        _close(jg_, g)


def test_iterative_mll_tracks_dense_with_own_probes():
    """The port's own probes (a generator), against the port's dense MLL."""
    _, tm, jp, _, ts = _setup(1)
    tp, leaves = _tparams(jp)
    dense = torch.sum(tw.wiski_mll(tm, tp, ts, SolverConfig()))
    g_dense = torch.cat([g.reshape(-1) for g in torch.autograd.grad(dense, leaves)])
    it = torch.sum(tw.wiski_mll(tm, tp, ts, SolverConfig(**ITER), generator=torch.Generator().manual_seed(11)))
    g_it = torch.cat([g.reshape(-1) for g in torch.autograd.grad(it, leaves)])
    np.testing.assert_allclose(float(it.detach()), float(dense.detach()), rtol=0.15)
    cos = float(g_dense @ g_it / (torch.linalg.norm(g_dense) * torch.linalg.norm(g_it)))
    assert cos > 0.97, f"gradient cosine {cos}"


def test_iterative_mll_probes_default_to_a_seeded_generator():
    _, tm, jp, _, ts = _setup(1)
    tp, _ = _tparams(jp)
    cfg = SolverConfig(**ITER)
    with torch.no_grad():
        a = tw.wiski_mll(tm, tp, ts, cfg)
        b = tw.wiski_mll(tm, tp, ts, cfg, generator=torch.Generator().manual_seed(0))
        c = tw.wiski_mll(tm, tp, ts, cfg, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture
def jax_start_vector(monkeypatch):
    """The port's Lanczos start vector replaced by JAX's normal(PRNGKey(0))."""
    def start(m, dtype=torch.float32, device=None):
        v = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (m,), jnp.float64))
        return torch.tensor(v, dtype=dtype, device=device)

    monkeypatch.setattr(tw, "root_start_vector", start)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("use_toeplitz", [False, True])
def test_fast_pred_var_rank_capped_matches_jax(B, use_toeplitz):
    jm, tm, jp, js, ts = _setup(B)
    tp, _ = _tparams(jp)
    jcfg = JConfig(fast_pred_var=True, max_root_decomposition_size=16, use_toeplitz=use_toeplitz)
    jc = jax.jit(jw.wiski_prediction_caches, static_argnums=(0, 3))(jm, jp, js, jcfg)
    with torch.no_grad():
        tc = tw.wiski_prediction_caches(tm, tp, ts, SolverConfig(
            fast_pred_var=True, max_root_decomposition_size=16, use_toeplitz=use_toeplitz))
    _close(jc[0], tc[0])
    _close(jc[1], tc[1])
    xt = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (16, 2), minval=-1, maxval=1, dtype=jnp.float64))
    jpred = jax.jit(jw.wiski_predict, static_argnums=(0, 4))(jm, jp, js, jnp.asarray(xt), jcfg, caches=jc)
    with torch.no_grad():
        tpred = tw.wiski_predict(tm, tp, ts, torch.tensor(xt), caches=tc)
    for a, b in zip(jpred, tpred):
        _close(a, b)


@pytest.mark.parametrize("rank", [16, 64])
def test_predict_root_and_fast_pred_samples_match_jax(jax_start_vector, rank):
    """Below full rank (16 < m = 64: the Lanczos root) and at it (the
    jittered Cholesky); the root is compared as root @ root^T."""
    jm, tm, jp, js, ts = _setup(3)
    tp, _ = _tparams(jp)
    xt = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (10, 2), minval=-1, maxval=1, dtype=jnp.float64))
    jcfg = JConfig(max_root_decomposition_size=rank)
    tcfg = SolverConfig(max_root_decomposition_size=rank)
    jmean, jroot = jax.jit(jw.wiski_predict_root, static_argnums=(0, 4))(jm, jp, js, jnp.asarray(xt), jcfg)
    with torch.no_grad():
        tmean, troot = tw.wiski_predict_root(tm, tp, ts, torch.tensor(xt), tcfg)
    assert troot.shape == (3, 10, rank)
    _close(jmean, tmean)
    _close(jroot @ jnp.swapaxes(jroot, -1, -2), troot @ troot.mT)
    jcfg_s, tcfg_s = jcfg.replace(fast_pred_samples=True), tcfg.replace(fast_pred_samples=True)
    jpred = jax.jit(jw.wiski_predict, static_argnums=(0, 4))(jm, jp, js, jnp.asarray(xt), jcfg_s)
    with torch.no_grad():
        tpred = tw.wiski_predict(tm, tp, ts, torch.tensor(xt), tcfg_s)
    for a, b in zip(jpred, tpred):
        _close(a, b)
