"""The port's exact and local-GP baseline wrappers against the JAX
package's, as test_torch_baselines.py runs the sparse ones: each port
wrapper starts from the JAX wrapper's state through ``convert`` (the JAX
params cast to float64, float64 inputs, an ``IdentityStem``), then a
1-epoch ``fit``, 8 ``update()``s at q = 1, ``predict`` and ``evaluate``,
compared after the fit and after the updates to rtol 1e-5 against each
quantity's largest entry.

- ``OnlineExactRegression`` at two outputs, ``OnlineExactClassifier`` at
  two classes (Dirichlet targets, float32 in both packages);
- ``OnlineLocalGPRegression`` with experts of 16 points, so that routing
  fills experts and spawns new ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu import api as japi
from online_gp_torch import api as tapi
from online_gp_torch import convert
from online_gp_torch.data import banana_dataset, sin_cos_dataset, streaming_friedman

RTOL = 1e-5
N_INIT, N_FIT, N_UPD = 30, 48, 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, what):
    want, got = np.asarray(_np(want), np.float64), np.asarray(_np(got), np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _tree_close(want, got, what):
    if isinstance(want, dict):
        assert set(want) == set(got), what
        for k in want:
            _tree_close(want[k], got[k], f"{what}/{k}")
    else:
        _close(want, got, what)


def _f64(tree):
    return jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), tree)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _regression_data(outputs=1):
    if outputs == 2:
        tx, ty, ex, ey = sin_cos_dataset(n=300, seed=0)
    else:
        tx, ty, ex, ey = streaming_friedman(n=300, num_dims=2, seed=0)
    return tx.astype(np.float64), ty.astype(np.float64), ex[:40].astype(np.float64), ey[:40].astype(np.float64)


def _classification_data():
    tx, ty, ex, ey = banana_dataset(n=300, seed=0)
    return tx.astype(np.float64), ty, ex[:40].astype(np.float64), ey[:40]


def _run(jr, tr, tx, ty, compare, fit_kw=None):
    """fit, then 8 updates, comparing after each phase; returns the pair."""
    fit_kw = fit_kw or {}
    jrec = jr.fit(tx[:N_FIT], ty[:N_FIT], 1, **fit_kw)
    trec = tr.fit(tx[:N_FIT], ty[:N_FIT], 1, **fit_kw)
    _close(jrec[0]["train_loss"], trec[0]["train_loss"], "fit loss")
    compare(jr, tr, "after fit")
    for i in range(N_FIT, N_FIT + N_UPD):
        jl, tl = jr.update(tx[i : i + 1], ty[i : i + 1]), tr.update(tx[i : i + 1], ty[i : i + 1])
        if np.isfinite(jl[0]):
            _close(jl, tl, f"update {i} loss")
        else:
            assert not np.isfinite(tl[0])
    compare(jr, tr, "after updates")


# -- exact --------------------------------------------------------------------


def _exact_pair(cls, tx, ty, **kw):
    jr = getattr(japi, cls)(japi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], lr=0.05, **kw)
    jr.params = _f64(jr.params)
    jr.opt_state = jr.opt.init((jr.params, jr.stem_params))
    tr = getattr(tapi, cls)(tapi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], lr=0.05, device="cpu", **kw)
    d = jr.data
    convert.load_exact(tr, _host(jr.params), {}, {}, dict(x=d.x, y=d.y, noise=d.noise, mask=d.mask, count=d.count),
                       np.asarray(jr._raw[0]), device="cpu")
    return jr, tr


def _exact_compare(jr, tr, what):
    _tree_close(jr.params, tr.params, f"{what}: params")
    for name in ("x", "y", "noise", "mask"):
        _close(getattr(jr.data, name), getattr(tr.data, name), f"{what}: data.{name}")
    assert int(jr.data.count) == tr.data.count


def test_exact_regression_matches_jax():
    tx, ty, ex, ey = _regression_data(outputs=2)
    jr, tr = _exact_pair("OnlineExactRegression", tx, ty)
    _run(jr, tr, tx, ty, _exact_compare)
    assert tr.data.x.shape[0] == 64  # the appends doubled the buffer
    for a, b in zip(jr.predict(ex), tr.predict(ex)):
        _close(a, b, "predict")
    _close(jr.evaluate(ex, ey), tr.evaluate(ex, ey), "evaluate")
    _close(jr.noise, tr.noise, "noise")


def test_exact_classifier_matches_jax():
    tx, ty, ex, ey = _classification_data()
    jr, tr = _exact_pair("OnlineExactClassifier", tx, ty)
    _run(jr, tr, tx, ty, _exact_compare)
    np.testing.assert_array_equal(_np(tr.predict(ex)), np.asarray(jr.predict(ex)))
    _close(jr.evaluate(ex, ey), tr.evaluate(ex, ey), "accuracy")  # a float32 mean in both


# -- local GP -------------------------------------------------------------------


def test_localgp_matches_jax():
    tx, ty, ex, ey = _regression_data()
    kw = dict(lr=0.05, max_data_per_model=16, max_experts=8)
    jr = japi.OnlineLocalGPRegression(japi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], **kw)
    jr.params = _f64(jr.params)
    jr.opt_state = jr.opt.init((jr.params, jr.stem_params))
    tr = tapi.OnlineLocalGPRegression(tapi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], device="cpu", **kw)
    convert.load_localgp(tr, _host(jr.params), {}, {}, _host(jr.state._asdict()), device="cpu")

    def compare(jr, tr, what):
        _tree_close(jr.params, tr.params, f"{what}: params")
        for name in jr.state._fields:
            _close(getattr(jr.state, name), getattr(tr.state, name), f"{what}: state.{name}")

    _run(jr, tr, tx, ty, compare)
    assert tr.num_experts == jr.num_experts >= 3  # the stream spawned an expert
    for a, b in zip(jr.predict(ex), tr.predict(ex)):
        _close(a, b, "predict")
    _close(jr.evaluate(ex, ey), tr.evaluate(ex, ey), "evaluate")
