"""The online_gp_torch WISKI serving slice against the JAX functional core,
plus the port's ground rules.

The whole slice runs at float64 on an 8x8 grid for B=1 and B=2, with the
params and state carried across by ``online_gp_torch.convert``:
wiski_init -> wiski_stream (block 8) -> 3 x wiski_condition -> wiski_mll
-> wiski_prediction_caches -> wiski_predict -> wiski_prequential_stream,
every state field and output compared (single ops 1e-9, streams 1e-7).
"""

import ast
import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.config import SolverConfig as JSolverConfig
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import wiski as tw
from online_gp_torch.ops import cuda_chol, cuda_pred_stream, cuda_root_update, precision
from online_gp_torch.ops.root_update import RootCache

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-9
STREAM_TOL = 1e-7


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def _close_state(js, ts, tol):
    _close(js.wty, ts.wty, tol)
    _close(js.ydy, ts.ydy, tol)
    _close(js.d_logdet, ts.d_logdet, tol)
    _close(js.roots.root, ts.roots.root, tol)
    _close(js.roots.inv_root, ts.roots.inv_root, tol)
    if js.roots.mat is None:
        assert ts.roots.mat is None
    else:
        _close(js.roots.mat, ts.roots.mat, tol)
    assert int(js.num_data) == ts.num_data


def _models(B):
    jg = JGrid.create([(-1.1, 1.1)] * 2, 8, dtype=jnp.float64)
    jm = jw.WiskiModel(JRBF(), jg, num_outputs=B, learn_additional_noise=True)
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    tm = tw.WiskiModel(RBFKernel(), tg, num_outputs=B, learn_additional_noise=True)
    jp = jm.init_params(2, dtype=jnp.float64)
    jp["raw_second_noise"] = jp["raw_second_noise"] + 0.25  # s2 != 1
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] - 0.3
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp


_STATE_ONLY = ("wiski_slim", "wiski_unslim", "wiski_refresh_roots", "wiski_check_decomposition")


@functools.lru_cache(maxsize=None)
def _jitted(name):
    """The JAX function, jitted (the model static): one compile per
    function instead of one per eager op."""
    if name in _STATE_ONLY:
        return jax.jit(getattr(jw, name))
    static = ("block_size",) if name in ("wiski_stream", "wiski_prequential_stream") else ()
    return jax.jit(getattr(jw, name), static_argnums=(0,), static_argnames=static)


def _data(rng, n, B, lo=-1.0, hi=1.0):
    x = rng.uniform(lo, hi, (n, 2))
    y = np.sin(2.5 * x[:, :1]) * np.linspace(1.0, 0.5, B)[None] + 0.05 * rng.normal(size=(n, B))
    noise = rng.uniform(0.3, 0.7, (n, B))
    return x, y, noise


@pytest.mark.parametrize("B", [1, 2])
def test_wiski_slice_matches_jax(B):
    rng = np.random.default_rng(B)
    jm, tm, jp, tp = _models(B)
    J, T = jnp.asarray, torch.tensor

    x0, y0, n0 = _data(rng, 30, B)
    js = _jitted("wiski_init")(jm, J(x0), J(y0), J(n0))
    ts = tw.wiski_init(tm, T(x0), T(y0), T(n0))
    _close_state(js, ts, TOL)

    # points beyond the bounds exercise the stencil clamp
    xs, ys, ns = _data(rng, 21, B, -1.4, 1.4)
    js = _jitted("wiski_stream")(jm, js, J(xs), J(ys), J(ns), block_size=8)
    ts = tw.wiski_stream(tm, ts, T(xs), T(ys), T(ns), block_size=8)
    _close_state(js, ts, STREAM_TOL)

    for i in range(3):
        js = _jitted("wiski_condition")(jm, js, J(xs[i : i + 1]), J(ys[i : i + 1]), J(ns[i : i + 1]))
        ts = tw.wiski_condition(tm, ts, T(xs[i : i + 1]), T(ys[i : i + 1]), T(ns[i : i + 1]))
        _close_state(js, ts, STREAM_TOL)

    _close(_jitted("wiski_mll")(jm, jp, js), tw.wiski_mll(tm, tp, ts), TOL)

    jc = _jitted("wiski_prediction_caches")(jm, jp, js)
    tc = tw.wiski_prediction_caches(tm, tp, ts)
    _close(jc[0], tc[0], TOL)
    _close(jc[1], tc[1], TOL)

    xt = rng.uniform(-1.0, 1.0, (17, 2))
    for a, b in zip(_jitted("wiski_predict")(jm, jp, js, J(xt), caches=jc), tw.wiski_predict(tm, tp, ts, T(xt), caches=tc)):
        _close(a, b, TOL)

    xq, yq, nq = _data(rng, 19, B)
    jo = _jitted("wiski_prequential_stream")(jm, jp, js, jc, J(xq), J(yq), J(nq), block_size=8)
    to = tw.wiski_prequential_stream(tm, tp, ts, tc, T(xq), T(yq), T(nq), block_size=8)
    _close_state(jo[0], to[0], STREAM_TOL)
    _close(jo[1][0], to[1][0], STREAM_TOL)
    _close(jo[1][1], to[1][1], STREAM_TOL)
    _close(jo[2], to[2], STREAM_TOL)
    _close(jo[3], to[3], STREAM_TOL)


def test_state_conversion_and_cache_maintenance_match():
    rng = np.random.default_rng(7)
    jm, tm, jp, tp = _models(2)
    x0, y0, n0 = _data(rng, 25, 2)
    js = _jitted("wiski_init")(jm, jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(n0))
    a = lambda v: None if v is None else np.asarray(v)
    ts = convert.state_from_numpy(
        a(js.wty), a(js.ydy), a(js.roots.mat), a(js.roots.root), a(js.roots.inv_root),
        a(js.d_logdet), a(js.num_data), device="cpu",
    )
    _close_state(js, ts, 0)
    # the MLL reads every state field
    _close(_jitted("wiski_mll")(jm, jp, js), tw.wiski_mll(tm, tp, ts), TOL)
    for jd, td in [(js, ts), (jw.wiski_slim(js), tw.wiski_slim(ts))]:
        _close_state(_jitted("wiski_refresh_roots")(jd), tw.wiski_refresh_roots(td), TOL)
        _close_state(_jitted("wiski_unslim")(jd), tw.wiski_unslim(td), TOL)
        jchk, tchk = _jitted("wiski_check_decomposition")(jd), tw.wiski_check_decomposition(td)
        assert jchk.keys() == tchk.keys()
        for key in jchk:
            np.testing.assert_allclose(tchk[key].numpy(), np.asarray(jchk[key]), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("q", [1, 3])
def test_rank_q_condition_and_pred_cache_condition_match(q):
    rng = np.random.default_rng(10 + q)
    jm, tm, jp, tp = _models(2)
    J, T = jnp.asarray, torch.tensor
    x0, y0, n0 = _data(rng, 25, 2)
    xq, yq, nq = _data(rng, q, 2)
    js = _jitted("wiski_init")(jm, J(x0), J(y0), J(n0))
    ts = tw.wiski_init(tm, T(x0), T(y0), T(n0))
    jc, tc = _jitted("wiski_prediction_caches")(jm, jp, js), tw.wiski_prediction_caches(tm, tp, ts)
    jcond = _jitted("wiski_condition")(jm, js, J(xq), J(yq), J(nq))
    _close_state(jcond, tw.wiski_condition(tm, ts, T(xq), T(yq), T(nq)), TOL)
    for a, b in zip(_jitted("wiski_pred_cache_condition")(jm, jc, J(xq), J(yq), J(nq)),
                    tw.wiski_pred_cache_condition(tm, tc, T(xq), T(yq), T(nq))):
        _close(a, b, TOL)


def test_stream_per_point_path_matches_blocked():
    rng = np.random.default_rng(8)
    _, tm, _, _ = _models(2)
    x0, y0, n0 = _data(rng, 25, 2)
    xs, ys, ns = _data(rng, 11, 2)
    T = torch.tensor
    state = tw.wiski_slim(tw.wiski_init(tm, T(x0), T(y0), T(n0)))
    per_point = tw.wiski_stream(tm, state, T(xs), T(ys), T(ns), block_size=1)
    blocked = tw.wiski_stream(tm, state, T(xs), T(ys), T(ns), block_size=4)
    _close_state(per_point, blocked, STREAM_TOL)


def test_solver_config_matches_jax_defaults():
    assert dataclasses.asdict(SolverConfig()) == dataclasses.asdict(JSolverConfig())
    assert SolverConfig().replace(fast_pred_var=True).fast_pred_var
    sharded = SolverConfig(grid_shard_axis="tp")  # the grid-sharded path (parallel/grid.py)
    assert dataclasses.asdict(sharded) == dataclasses.asdict(JSolverConfig(grid_shard_axis="tp"))


def test_precision_context_turns_tf32_off_and_restores():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    with precision.f32_matmul_precision():
        precision.assert_true_f32()
        assert not torch.backends.cudnn.allow_tf32
    after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    assert after == before


def _port_files():
    return sorted((REPO / "online_gp_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    banned = ("jax", "jaxlib", "optax", "online_gp_tpu")
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"
    code = (
        "import sys, importlib, pkgutil, online_gp_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(online_gp_torch.__path__, 'online_gp_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'online_gp_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def _launch_counts():
    ru = cuda_root_update
    return (ru.rank1_apply.launches, ru.blocked_chunk.launches, ru.blocked_chunk.cluster_launches,
            ru.blocked_chunk.sub_launches, ru.blocked_chunk.sub_cluster_launches, ru.blocked_chunk.coord_launches,
            ru.rank1_update.launches,
            cuda_pred_stream.pred_chunk.launches, cuda_pred_stream.pred_chunk.cluster_launches,
            cuda_chol.blocked_cholesky.launches)


def test_cpu_tensors_never_touch_launch_counters():
    before = _launch_counts()
    rng = np.random.default_rng(9)
    _, tm, _, tp = _models(1)
    x0, y0, n0 = _data(rng, 20, 1)
    xs, ys, ns = _data(rng, 9, 1)
    T = torch.tensor
    state = tw.wiski_slim(tw.wiski_init(tm, T(x0), T(y0), T(n0)))
    caches = tw.wiski_prediction_caches(tm, tp, state)
    state = tw.wiski_condition(tm, state, T(xs[:1]), T(ys[:1]), T(ns[:1]))
    state = tw.wiski_stream(tm, state, T(xs), T(ys), T(ns), block_size=4)
    tw.wiski_prequential_stream(tm, tp, state, caches, T(xs), T(ys), T(ns), block_size=4)
    full = tw.wiski_init(tm, T(x0), T(y0), T(n0)).roots
    v = torch.tensor(rng.normal(size=(1, full.root.shape[-1], 1)))
    cuda_root_update.fused_root_cache_update(full, v)
    cuda_root_update.fused_root_cache_update(RootCache(None, full.root, full.inv_root), v)
    L, B = state.roots.root, state.roots.inv_root
    idx, wv = torch.tensor(rng.integers(0, L.shape[-1], (8, 4))), torch.tensor(rng.uniform(size=(1, 8, 4)))
    cuda_root_update.blocked_chunk(L, B, idx, wv, sub=4)
    cuda_root_update.blocked_chunk(L, B, idx, wv, mode="coord")
    cuda_chol.blocked_cholesky(full.mat + torch.eye(full.mat.shape[-1], dtype=full.mat.dtype), block=16)
    assert _launch_counts() == before


def test_kernels_raise_on_devices_they_do_not_take():
    """No fallback: a tensor that is neither on the CPU nor a float32 CUDA
    tensor raises, naming the plain version."""
    m, k, P = 8, 2, 4
    meta = dict(device="meta", dtype=torch.float32)
    L = torch.empty((1, m, m), **meta)
    idx = torch.empty((k, P), device="meta", dtype=torch.int32)
    with pytest.raises(TypeError, match="rank1_apply_plain"):
        cuda_root_update.rank1_apply(L, L, torch.empty((1, m), **meta))
    with pytest.raises(TypeError, match="blocked_chunk_plain"):
        cuda_root_update.blocked_chunk(L, L, idx, torch.empty((1, k, P), **meta))
    with pytest.raises(TypeError, match="pred_chunk_stencil_plain"):
        cuda_pred_stream.pred_chunk(
            L, torch.empty((1, m), **meta), idx, torch.empty((k, P), **meta),
            torch.empty((1, k), **meta), torch.empty((1, k), **meta),
        )
    v = torch.empty((1, m, 1), **meta)
    for A in (L, None):
        with pytest.raises(TypeError, match="rank1_update_plain"):
            cuda_root_update.rank1_update(L, L, A, v)
        with pytest.raises(TypeError, match="rank1_update_plain"):
            cuda_root_update.fused_root_cache_update(RootCache(A, L, L), v)
        # unbatched q = 1 is K4's too, never the plain root_cache_update
        with pytest.raises(TypeError, match="rank1_update_plain"):
            cuda_root_update.fused_root_cache_update(RootCache(None if A is None else A[0], L[0], L[0]), v[0])
    for options in (dict(sub=1), dict(mode="coord")):
        with pytest.raises(TypeError, match="blocked_chunk_plain"):
            cuda_root_update.blocked_chunk(L, L, idx, torch.empty((1, k, P), **meta), **options)
    with pytest.raises(TypeError, match="blocked_cholesky_plain"):
        cuda_chol.blocked_cholesky(L)


class _FakeCudaTensor:
    """Stands in for a CUDA tensor where there is no card: the argument
    checks read only these attributes."""

    def __init__(self, dtype=torch.float32, requires_grad=False, contiguous=True, index=0):
        self.device = torch.device("cuda", index)
        self.dtype = dtype
        self.requires_grad = requires_grad
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float64), "dtype torch.float64"),
    (dict(requires_grad=True), "requires grad"),
    (dict(contiguous=False), "not contiguous"),
    (dict(index=1), "the other arguments"),
])
def test_cuda_argument_checks_raise(bad, match):
    """On CUDA the kernels take float32, contiguous, grad-free tensors on
    one device and raise on anything else, naming the plain version."""
    from online_gp_torch.ops import _build

    good = _FakeCudaTensor()
    _build.check_cuda_args("blocked_chunk_plain", ints=("idx",), L=good, B=good,
                           idx=_FakeCudaTensor(dtype=torch.int32), wv=good)
    with pytest.raises(TypeError, match=match) as err:
        _build.check_cuda_args("blocked_chunk_plain", L=good, B=_FakeCudaTensor(**bad))
    assert "blocked_chunk_plain" in str(err.value)
