"""The port's large-grid wrappers against the JAX package's.

- The router: ``OnlineSKIRegression`` returns the rank-capped wrapper for
  ``low_rank=`` and for grids above ``DENSE_GRID_LIMIT``, and stays dense
  otherwise (tests/api/test_lowrank_switch.py:28-48), passing ``device``
  through.
- ``OnlineSKILowRankRegression`` against JAX's at float64 inputs, with the
  stem, params and state carried across by ``convert``: 3 ``update()``s,
  ``fit``, ``predict`` and ``evaluate``, for one output with Toeplitz
  products and two outputs with Kronecker ones. The params are float32, as in JAX, so the two agree to
  float32 rounding: rtol 1e-5 against each quantity's largest entry, as the
  dense wrapper's parity test. The params themselves are held to a
  thousandth of one Adam step (1e-3 lr) as well: after ``fit`` the raw
  output scale sits near 0 with a gradient ~1e-4 of the others', a
  cancellation that turns float32 rounding of the kernel factors (and of
  the column's float32 FFT under Toeplitz) into 2e-6 to 8e-6 of its value
  by Adam's second step (4e-5 to 2e-4 of one step).

The wrappers run in the root buffer's exact regime (rank 32, k_buf 64 for
at most 60 points). A compression keeps the top eigenvectors of a Gram
whose spectrum, for a smooth kernel, has fallen to ~1e-6 of its top by
the kept rank: a float32 perturbation of the Gram (the wrappers' float32
params) then moves the kept subspace, and L L^T with it, by far more than
float32 rounding, while the MLL moves little. Compressions are held to
JAX at float64 params in tests/test_torch_lowrank.py, with a checked gap.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.api import IdentityStem as JIdentity
from online_gp_tpu.api import LinearStem as JLinear
from online_gp_tpu.api.lowrank_regression import OnlineSKILowRankRegression as JLowRank
from online_gp_tpu.data import sin_cos_dataset
from online_gp_torch import convert
from online_gp_torch.api import IdentityStem, LinearStem, OnlineSKILowRankRegression, OnlineSKIRegression
from online_gp_torch.api.regression import DENSE_GRID_LIMIT

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over 64-element ops cost several
    times what they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, what):
    want, got = np.asarray(_np(want), np.float64), np.asarray(_np(got), np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _data(n, d=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    return x, (np.sin(4 * x[:, :1]) + 0.1 * rng.normal(size=(n, 1))).astype(np.float32)


def test_explicit_low_rank_routes():
    x, y = _data(64)
    w = OnlineSKIRegression(IdentityStem(1), x, y, grid_size=64, low_rank=32, device="cpu")
    assert isinstance(w, OnlineSKILowRankRegression)
    assert w.model.rank == 32 and w.device.type == "cpu" and w.state.root.device.type == "cpu"


def test_big_grid_auto_routes():
    x, y = _data(64)
    w = OnlineSKIRegression(IdentityStem(1), x, y, grid_size=DENSE_GRID_LIMIT + 1, device="cpu")
    assert isinstance(w, OnlineSKILowRankRegression)
    assert w.model.rank == 512 and w.model.grid.num_points == DENSE_GRID_LIMIT + 1


def test_small_grid_stays_dense():
    x, y = _data(64)
    w = OnlineSKIRegression(IdentityStem(1), x, y, grid_size=16, device="cpu")
    assert type(w) is OnlineSKIRegression


def test_dense_options_warn_on_the_low_rank_route():
    x, y = _data(32)
    with pytest.warns(UserWarning, match="dense-core options"):
        OnlineSKIRegression(IdentityStem(1), x, y, grid_size=64, low_rank=16, slim_state=True, device="cpu")


def _carry_over(jr, tr):
    a = lambda v: np.asarray(v)
    if tr.stem.has_params:
        convert.stem_from_numpy(tr.stem, jax.tree_util.tree_map(a, jr.stem_params),
                                jax.tree_util.tree_map(a, jr.stem_state), device="cpu")
    with torch.no_grad():
        for key in ("raw_lengthscale", "raw_outputscale"):
            tr.params["kernel"][key].copy_(torch.tensor(a(jr.params["kernel"][key])))
        tr.params["raw_second_noise"].copy_(torch.tensor(a(jr.params["raw_second_noise"])))
    s = jr.state
    tr.state = convert.lowrank_state_from_numpy(a(s.wty), a(s.ydy), a(s.root), a(s.used), a(s.d_logdet),
                                                a(s.num_data), device="cpu")


def _close_params(want, got, lr, what):
    want, got = np.asarray(_np(want), np.float64), np.asarray(_np(got), np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=max(RTOL * scale, 1e-3 * lr), err_msg=what)


def _close_models(jr, tr, what):
    for key in ("raw_lengthscale", "raw_outputscale"):
        _close_params(jr.params["kernel"][key], tr.params["kernel"][key], jr.lr, f"{what}: {key}")
    _close_params(jr.params["raw_second_noise"], tr.params["raw_second_noise"], jr.lr, f"{what}: second noise")
    js, ts = jr.state, tr.state
    for name in ("wty", "ydy", "d_logdet"):
        _close(getattr(js, name), getattr(ts, name), f"{what}: {name}")
    jroot = np.asarray(js.root)
    _close(jroot @ np.swapaxes(jroot, -1, -2), ts.root @ ts.root.mT, f"{what}: L L^T")
    assert set(np.unique(np.asarray(js.used))) == {ts.used}
    assert set(np.unique(np.asarray(js.num_data))) == {ts.num_data}
    assert ts.wty.dtype == torch.float64


@pytest.mark.parametrize("outputs,use_toeplitz", [(1, True), (2, False)])
def test_lowrank_wrapper_sequence_matches_jax(outputs, use_toeplitz):
    tx, ty, *_ = sin_cos_dataset(n=200, seed=0)
    tx = tx.astype(np.float64)
    ty = np.concatenate([ty, np.cos(2 * tx[:, :1])], axis=-1)[:, :outputs].astype(np.float64)
    kw = dict(lr=0.05, grid_size=12, grid_bound=1.0, low_rank=32, use_toeplitz=use_toeplitz)
    from online_gp_tpu.api import OnlineSKIRegression as JRegression

    jr = JRegression(JLinear(2, 2), tx[:40], ty[:40], **kw)
    assert isinstance(jr, JLowRank)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = OnlineSKIRegression(LinearStem(2, 2), tx[:40], ty[:40], device="cpu", **kw)
    assert isinstance(tr, OnlineSKILowRankRegression) and tr.model.k_buf == 64
    _carry_over(jr, tr)
    _close_models(jr, tr, "carried over")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # update_stem is ignored, with a warning
        for i in range(40, 43):
            _close(jr.update(tx[i : i + 1], ty[i : i + 1]), tr.update(tx[i : i + 1], ty[i : i + 1]), f"update {i}")
    _close_models(jr, tr, "after 3 updates")
    for a, b in zip(jr.predict(tx[100:130]), tr.predict(tx[100:130])):
        assert tuple(b.shape) == (30, outputs)
        _close(a, b, "predict")
    jrec, trec = jr.fit(tx[:60], ty[:60], 2), tr.fit(tx[:60], ty[:60], 2)
    _close([r["train_loss"] for r in jrec], [r["train_loss"] for r in trec], "fit train_loss")
    _close_models(jr, tr, "after fit")
    assert tr.state.used == tr.state.num_data == 60  # no compression
    for a, b in zip(jr.predict(tx[100:130]), tr.predict(tx[100:130])):
        _close(a, b, "predict after fit")
    _close(jr.evaluate(tx[100:130], ty[100:130]), tr.evaluate(tx[100:130], ty[100:130]), "evaluate")
    _close(jr.noise, tr.noise, "noise")


def test_lowrank_update_warns_once_about_the_stem():
    x, y = _data(40, d=2)
    tr = OnlineSKILowRankRegression(LinearStem(2, 2), x, y, grid_size=12, rank=8, device="cpu")
    with pytest.warns(UserWarning, match="update_stem is ignored"):
        tr.update(x[:1], y[:1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.update(x[1:2], y[1:2])
    mean, var = tr.predict(x[:5])
    assert mean.shape == var.shape == (5, 1) and bool((var > 0).all())


def test_identity_stem_lowrank_wrapper_matches_jax():
    """No stem parameters, a 1-D grid of 64 (the switch tests' shape)."""
    x, y = _data(48, seed=3)
    x, y = x.astype(np.float64), y.astype(np.float64)
    jr = JLowRank(JIdentity(1), x[:40], y[:40], lr=0.05, grid_size=64, rank=32)
    tr = OnlineSKILowRankRegression(IdentityStem(1), x[:40], y[:40], lr=0.05, grid_size=64, rank=32, device="cpu")
    _carry_over(jr, tr)
    for i in range(40, 44):
        _close(jr.update(x[i : i + 1], y[i : i + 1]), tr.update(x[i : i + 1], y[i : i + 1]), f"update {i}")
    _close_models(jr, tr, "after 4 updates")
    for a, b in zip(jr.predict(x[:16]), tr.predict(x[:16])):
        _close(a, b, "predict")
