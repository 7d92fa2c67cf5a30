"""The port's rank-capped classifier against the JAX package's.

``OnlineSKILowRankClassifier`` at grid 16 (m = 256) with ``low_rank=64``,
reached through ``OnlineSKIClassifier``'s router as users reach it, on
float64 inputs. The port's wrapper is started from the JAX one's params,
stem and state (``convert``); both are put on one float64 grid with float64
params first, as the dense classifier's parity test does and for the same
reason (XLA fuses the float32 grid's arithmetic under jit). Then: the
carried-over state, an ``update()`` at q = 4, a 3-epoch ``fit``, and
``predict`` (labels equal). The runs stay in the root buffer's exact
regime (at most 68 of k_buf = 128 columns, no compression: a compression's
kept subspace moves with rounding, see tests/test_torch_lowrank_regression.py).
Params and L L^T to 1e-8; y^T D^-1 y, log|D| and the losses to float32
rounding (1e-6), since the Dirichlet targets and noise are float32 in both.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.api import IdentityStem as JIdentity
from online_gp_tpu.api import LinearStem as JLinear
from online_gp_tpu.api.classification import OnlineSKIClassifier as JClassifier
from online_gp_tpu.api.lowrank_classification import OnlineSKILowRankClassifier as JLowRank
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.api import IdentityStem, LinearStem, OnlineSKIClassifier, OnlineSKILowRankClassifier
from online_gp_torch.data import banana_dataset

TOL = 1e-8
F32_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors (see
    tests/test_torch_lowrank_regression.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, what, tol=TOL):
    want, got = np.asarray(_np(want), np.float64), np.asarray(_np(got), np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _start_together(jc, tc):
    """One float64 grid and float64 params for both; the port's wrapper
    starts from the JAX one's params, stem and state."""
    f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
    grid = JGrid.create([(-1.1, 1.1)] * 2, jc.model.grid.sizes, dtype=jnp.float64)
    jc.model = jc.model._replace(grid=grid)
    tc.model = tc.model._replace(grid=convert.grid_from_numpy(
        grid.sizes, np.asarray(grid.mins), np.asarray(grid.spacings), device="cpu"))
    jc.params = f64(jc.params)
    jc.gp_opt_state = jc.gp_opt.init(jc.params)
    a = lambda t: jax.tree_util.tree_map(np.asarray, t)
    s = jc.state
    state = dict(wty=s.wty, ydy=s.ydy, root=s.root, used=s.used, d_logdet=s.d_logdet, num_data=s.num_data)
    convert.load_wrapper(tc, a(jc.params), a(jc.stem_params), a(jc.stem_state), a(state))


def _close_models(jc, tc, what):
    for key in ("raw_lengthscale", "raw_outputscale"):
        _close(jc.params["kernel"][key], tc.params["kernel"][key], f"{what}: {key}")
    js, ts = jc.state, tc.state
    _close(js.wty, ts.wty, f"{what}: wty")
    for name in ("ydy", "d_logdet"):
        _close(getattr(js, name), getattr(ts, name), f"{what}: {name}", F32_TOL)
    jroot = np.asarray(js.root)
    _close(jroot @ np.swapaxes(jroot, -1, -2), ts.root @ ts.root.mT, f"{what}: L L^T")
    assert set(np.unique(np.asarray(js.used))) == {ts.used}
    assert set(np.unique(np.asarray(js.num_data))) == {ts.num_data}


@pytest.mark.parametrize("stem", ["identity", "linear"])
def test_lowrank_classifier_matches_jax(stem):
    tr_x, tr_y, te_x, _ = banana_dataset(n=400, seed=1)
    x, xt = tr_x.astype(np.float64), te_x[:40].astype(np.float64)
    jstem, tstem = (JIdentity(2), IdentityStem(2)) if stem == "identity" else (JLinear(2, 2), LinearStem(2, 2))
    kw = dict(alpha_eps=0.01, lr=0.05, grid_size=16, grid_bound=1.0, low_rank=64)
    jc = JClassifier(jstem, x[:64], tr_y[:64], **kw)
    tc = OnlineSKIClassifier(tstem, x[:64], tr_y[:64], device="cpu", **kw)
    assert isinstance(jc, JLowRank) and isinstance(tc, OnlineSKILowRankClassifier)
    assert tc.model.rank == 64 and tc.model.k_buf == 128 and not tc.model.learn_additional_noise
    _start_together(jc, tc)
    _close_models(jc, tc, "carried over")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # update_stem is ignored, with a warning
        want, got = jc.update(x[64:68], tr_y[64:68]), tc.update(x[64:68], tr_y[64:68])
    assert got[0] == want[0] == 0.0
    _close(want[1], got[1], "update loss", F32_TOL)
    _close_models(jc, tc, "after an update at q = 4")
    np.testing.assert_array_equal(_np(tc.predict(xt)), np.asarray(jc.predict(xt)))

    jrec, trec = jc.fit(x[:68], tr_y[:68], 3), tc.fit(x[:68], tr_y[:68], 3)
    _close([r["train_loss"] for r in jrec], [r["train_loss"] for r in trec], "fit losses", F32_TOL)
    _close_models(jc, tc, "after fit")
    assert tc.state.used == tc.state.num_data == 68  # no compression
    pred = tc.predict(xt)
    assert pred.dtype == torch.int64 and pred.shape == (40,)
    np.testing.assert_array_equal(_np(pred), np.asarray(jc.predict(xt)))


def test_lowrank_classifier_warns_once_and_freezes_without_gp_step():
    tr_x, tr_y, te_x, te_y = banana_dataset(n=300, seed=2)
    tc = OnlineSKILowRankClassifier(LinearStem(2, 2), tr_x[:40], tr_y[:40], grid_size=16, rank=16, device="cpu")
    with pytest.warns(UserWarning, match="update_stem is ignored"):
        tc.update(tr_x[40:41], tr_y[40:41])
    before = [t.detach().clone() for t in tc.params["kernel"].values()]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tc.update(tr_x[41:43], tr_y[41:43], update_gp=False) == (0.0, 0.0)
    assert all(torch.equal(a, b) for a, b in zip(before, tc.params["kernel"].values()))
    assert tc.state.num_data == 43
    records = tc.fit(tr_x[:43], tr_y[:43], 2, test_dataset=(te_x, te_y))
    assert len(records) == 2 and "test_acc" not in records[0] and 0.0 <= records[-1]["test_acc"] <= 1.0
