"""The rest of the port's WISKI core against the JAX package: fantasies, the
differentiable (``detach_interp=False``) conditioning routes, and the small
helpers they need.

- ``wiski_expand`` and ``wiski_fantasize`` at B = 2, F = 3, q = 2 (and
  q = 1) as tests/models/test_wiski_shapes.py:56-76, values to 1e-8 at
  float64, the base state left bitwise as it was.
- ``root_cache_expand`` (full and slim, tests/ops/test_root_update.py:78,
  124), ``chol_inverse``, ``Grid.from_data`` and ``full_points``.
- The gradient with respect to x of a scalar of the conditioned state:
  ``wiski_condition(detach_interp=False)`` at q = 1 and q = 2,
  ``wiski_stream`` and ``wiski_prequential_stream`` (several chunks),
  against ``jax.grad`` at float64, to 1e-8.
- A spy: ``detach_interp=False`` never reaches K2, K1 or K3's wrappers,
  and ``detach_interp=True`` still does.
- The stacked recursions (the forms autograd takes) equal the in-place
  ones they mirror, to float64 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops import chol as jchol
from online_gp_tpu.ops import root_update as jru
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import wiski as tw
from online_gp_torch.ops import chol as tchol
from online_gp_torch.ops import cuda_pred_stream, cuda_root_update
from online_gp_torch.ops import pred_stream as tps
from online_gp_torch.ops import root_update as tru
from online_gp_torch.ops.grid import Grid

TOL = 1e-8


def _close(want, got, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _models(B, grid_size=8):
    jg = JGrid.create([(-1.1, 1.1)] * 2, grid_size, dtype=jnp.float64)
    jm = jw.WiskiModel(JRBF(), jg, num_outputs=B, learn_additional_noise=True)
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    tm = tw.WiskiModel(RBFKernel(), tg, num_outputs=B, learn_additional_noise=True)
    jp = jm.init_params(2, dtype=jnp.float64)
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] - 0.3
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp


def _data(rng, n, B):
    x = rng.uniform(-1.0, 1.0, (n, 2))
    y = np.sin(2.5 * x[:, :1]) * np.linspace(1.0, 0.5, B)[None] + 0.05 * rng.normal(size=(n, B))
    return x, y, rng.uniform(0.3, 0.7, (n, B))


def _states(rng, B, n=30):
    jm, tm, jp, tp = _models(B)
    x0, y0, n0 = _data(rng, n, B)
    js = jax.jit(jw.wiski_init, static_argnums=0)(jm, jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(n0))
    ts = tw.wiski_init(tm, torch.tensor(x0), torch.tensor(y0), torch.tensor(n0))
    return jm, tm, jp, tp, js, ts


def _fields(state):
    r = state.roots
    return {"wty": state.wty, "ydy": state.ydy, "d_logdet": state.d_logdet, "mat": r.mat, "root": r.root,
            "inv_root": r.inv_root}


def _snapshot(state):
    return {k: None if v is None else v.detach().clone() for k, v in _fields(state).items()}


def _unchanged(state, snap):
    for k, v in _fields(state).items():
        assert (v is None) == (snap[k] is None) and (v is None or torch.equal(v, snap[k])), f"base state {k} moved"


@pytest.mark.parametrize("q", [2, 1])
def test_expand_and_fantasize_match_jax(q):
    B, F = 2, 3
    rng = np.random.default_rng(20 + q)
    jm, tm, _, _, js, ts = _states(rng, B)
    fx = rng.uniform(-1.0, 1.0, (F, q, 2))
    fy = rng.normal(size=(F, q, B))
    fn = rng.uniform(0.3, 0.7, (F, q, B))
    snap = _snapshot(ts)
    jf = jax.jit(jw.wiski_fantasize, static_argnums=0)(jm, js, jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(fn))
    tf = tw.wiski_fantasize(tm, ts, torch.tensor(fx), torch.tensor(fy), torch.tensor(fn))
    m = tm.grid.num_points
    assert tf.wty.shape == (F, B, m, 1) and tf.roots.mat.shape == (F, B, m, m)
    for (name, want), got in zip(_fields(jf).items(), _fields(tf).values()):
        _close(want, got, what=f"fantasy {name}")
    assert np.all(np.asarray(jf.num_data) == 30 + q) and tf.num_data == 30 + q
    _unchanged(ts, snap)

    je, te = jw.wiski_expand(js, F), tw.wiski_expand(ts, F)
    assert te.ydy.shape == (F, B) and te.roots.root.shape == (F, B, m, m)
    for (name, want), got in zip(_fields(je).items(), _fields(te).values()):
        _close(want, got, what=f"expanded {name}")
        assert all(torch.equal(got[f], _fields(ts)[name]) for f in range(F))

    # each fantasy is the plain conditioning of the base state on its points
    for f in range(F):
        one = tw.wiski_condition(tm, ts, torch.tensor(fx[f]), torch.tensor(fy[f]), torch.tensor(fn[f]),
                                 detach_interp=False)
        for name, got in _fields(tf).items():
            _close(_fields(one)[name].detach().numpy(), got[f], what=f"fantasy {f} {name}")


def test_root_cache_expand_full_and_slim():
    rng = np.random.default_rng(3)
    m = 10
    W = rng.normal(size=(2, m, 2 * m))
    A = W @ np.swapaxes(W, -1, -2) / (2 * m)
    jc = jru.root_cache_init(jnp.asarray(A), jitter=1e-12)
    tc = tru.root_cache_init(torch.tensor(A), jitter=1e-12)
    for jcache, tcache in ((jc, tc), (jru.root_cache_slim(jc), tru.root_cache_slim(tc))):
        je, te = jru.root_cache_expand(jcache, (3,)), tru.root_cache_expand(tcache, (3,))
        assert te.root.shape == (3, 2, m, m) and te.inv_root.shape == (3, 2, m, m)
        assert (te.mat is None) == (tcache.mat is None)
        for a, b in zip(je, te):
            if a is not None:
                _close(a, b, tol=1e-12)
    # the slim single-output form of tests/ops/test_root_update.py:124
    slim = tru.root_cache_expand(tru.root_cache_slim(tru.RootCache(*(None if t is None else t[0] for t in tc))), (3,))
    assert slim.mat is None and slim.root.shape == (3, m, m)


def test_chol_inverse_matches_jax():
    rng = np.random.default_rng(4)
    W = rng.normal(size=(3, 7, 12))
    A = W @ np.swapaxes(W, -1, -2) + np.eye(7)
    Lc = np.linalg.cholesky(A)
    got = tchol.chol_inverse(torch.tensor(Lc))
    _close(jchol.chol_inverse(jnp.asarray(Lc)), got, tol=1e-10)
    _close(np.linalg.inv(A), got, tol=1e-10)


def test_grid_from_data_and_full_points_match_jax():
    rng = np.random.default_rng(5)
    for dtype, jdt, tdt in ((np.float32, jnp.float32, torch.float32), (np.float64, jnp.float64, torch.float64)):
        x = rng.uniform(-0.7, 1.3, (40, 2)).astype(dtype)
        jg = JGrid.from_data(jnp.asarray(x), (6, 9), dtype=jdt)
        tg = Grid.from_data(torch.tensor(x), (6, 9), dtype=tdt)
        assert tg.sizes == jg.sizes and tg.device.type == "cpu"
        np.testing.assert_array_equal(tg.mins.numpy(), np.asarray(jg.mins))
        np.testing.assert_array_equal(tg.spacings.numpy(), np.asarray(jg.spacings))
        np.testing.assert_array_equal(tg.full_points().numpy(), np.asarray(jg.full_points()))
        assert tg.full_points().shape == (54, 2)


# ---------------------------------------------------------------------------
# gradients through the differentiable route
# ---------------------------------------------------------------------------


def _weights(rng, fields):
    """Fixed random weights for a scalar of the conditioned state's fields."""
    return {k: rng.normal(size=np.shape(v)) for k, v in fields.items() if v is not None}


def _scalar(fields, weights, lib):
    return sum(lib.sum(fields[k] * (torch.tensor(w) if lib is torch else jnp.asarray(w))) for k, w in weights.items())


def _tgrad(fn, x):
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(fn(xt), [xt])
    return g


@pytest.mark.parametrize("q", [1, 2])
def test_condition_gradient_matches_jax(q):
    B = 2
    rng = np.random.default_rng(30 + q)
    jm, tm, _, _, js, ts = _states(rng, B)
    x, y, n = _data(rng, q, B)
    weights = _weights(rng, _fields(ts))
    J = jnp.asarray

    def jf(xx):
        return _scalar(_fields(jw.wiski_condition(jm, js, xx, J(y), J(n), detach_interp=False)), weights, jnp)

    def tf(xx):
        out = tw.wiski_condition(tm, ts, xx, torch.tensor(y), torch.tensor(n), detach_interp=False)
        return _scalar(_fields(out), weights, torch)

    _close(jax.jit(jax.grad(jf))(J(x)), _tgrad(tf, x), what=f"d/dx condition q={q}")


def test_stream_gradient_matches_jax():
    B = 2
    rng = np.random.default_rng(40)
    jm, tm, _, _, js, ts = _states(rng, B)
    x, y, n = _data(rng, 12, B)
    weights = _weights(rng, _fields(ts))
    J = jnp.asarray

    def jf(xx):
        out = jw.wiski_stream(jm, js, xx, J(y), J(n), detach_interp=False, block_size=4)
        return _scalar(_fields(out), weights, jnp)

    def tf(xx):
        out = tw.wiski_stream(tm, ts, xx, torch.tensor(y), torch.tensor(n), detach_interp=False, block_size=4)
        return _scalar(_fields(out), weights, torch)

    _close(jax.jit(jax.grad(jf))(J(x)), _tgrad(tf, x), what="d/dx stream")


def test_prequential_gradient_matches_jax():
    B = 2
    rng = np.random.default_rng(50)
    jm, tm, jp, tp, js, ts = _states(rng, B)
    jc = jax.jit(jw.wiski_prediction_caches, static_argnums=0)(jm, jp, js)
    tc = tw.wiski_prediction_caches(tm, tp, ts)
    x, y, n = _data(rng, 12, B)
    weights = _weights(rng, _fields(ts))
    wc = [rng.normal(size=np.shape(c)) for c in jc] + [rng.normal(size=(B, 12))] * 2
    J = jnp.asarray

    def scalar(out, lib):
        state, caches, pm, pv = out
        extra = [caches[0], caches[1], pm, pv]
        T = torch.tensor if lib is torch else jnp.asarray
        return _scalar(_fields(state), weights, lib) + sum(lib.sum(a * T(w)) for a, w in zip(extra, wc))

    def jf(xx):
        return scalar(jw.wiski_prequential_stream(jm, jp, js, jc, xx, J(y), J(n), detach_interp=False,
                                                  block_size=4), jnp)

    def tf(xx):
        return scalar(tw.wiski_prequential_stream(tm, tp, ts, tc, xx, torch.tensor(y), torch.tensor(n),
                                                  detach_interp=False, block_size=4), torch)

    _close(jax.jit(jax.grad(jf))(J(x)), _tgrad(tf, x), what="d/dx prequential")


def test_differentiable_route_never_reaches_the_kernels(monkeypatch):
    """A spy on the wrappers of K2, K1 and K3: ``detach_interp=False``
    calls none of them (they raise on a tensor that needs grad on the card
    and write in place there), ``detach_interp=True`` calls each."""
    calls = []

    def spy(name, real):
        def wrapper(*args, **kw):
            calls.append(name)
            return real(*args, **kw)

        return wrapper

    monkeypatch.setattr(tw, "rank1_apply", spy("rank1_apply", tw.rank1_apply))
    monkeypatch.setattr(cuda_root_update, "blocked_chunk", spy("blocked_chunk", cuda_root_update.blocked_chunk))
    monkeypatch.setattr(cuda_pred_stream, "pred_chunk", spy("pred_chunk", cuda_pred_stream.pred_chunk))
    rng = np.random.default_rng(60)
    _, tm, _, tp, _, ts = _states(rng, 2)
    x, y, n = (torch.tensor(a) for a in _data(rng, 8, 2))
    caches = tw.wiski_prediction_caches(tm, tp, ts)

    def run(detach):
        tw.wiski_condition(tm, ts, x[:1], y[:1], n[:1], detach_interp=detach)
        tw.wiski_stream(tm, ts, x, y, n, detach_interp=detach, block_size=4)
        tw.wiski_stream(tm, ts, x[:2], y[:2], n[:2], detach_interp=detach, block_size=1)
        tw.wiski_prequential_stream(tm, tp, ts, caches, x, y, n, detach_interp=detach, block_size=4)

    run(False)
    tw.wiski_fantasize(tm, ts, x[:6].reshape(3, 2, 2), y[:6].reshape(3, 2, 2), n[:6].reshape(3, 2, 2))
    assert calls == []
    run(True)
    assert set(calls) == {"rank1_apply", "blocked_chunk", "pred_chunk"}


def test_stacked_recursions_equal_the_in_place_ones():
    rng = np.random.default_rng(70)
    p0 = torch.tensor(rng.normal(size=(2, 9, 20)))
    for a, b in zip(tru.blocked_factors(p0), tru.blocked_factors_stacked(p0)):
        _close(a.numpy(), b, tol=1e-12)
    m, k = 20, 6
    W = rng.normal(size=(2, m, m))
    C = torch.tensor(W @ np.swapaxes(W, -1, -2) / m)
    mu = torch.tensor(rng.normal(size=(2, m)))
    idx = torch.tensor(rng.integers(0, m, (k, 4)))
    wv = torch.tensor(rng.uniform(size=(k, 4)))
    y, nz = torch.tensor(rng.normal(size=(2, k))), torch.tensor(rng.uniform(0.3, 0.7, (2, k)))
    for a, b in zip(cuda_pred_stream.pred_chunk_stencil_plain(C, mu, idx, wv, y, nz),
                    tps.pred_chunk_stacked(C, mu, idx, wv, y, nz)):
        _close(a.numpy(), b, tol=1e-12)
