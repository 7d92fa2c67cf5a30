"""The port's sparse baseline wrappers (O-SGPR, O-SVGP) against the JAX
package's; the exact and local-GP wrappers are in
test_torch_baselines_exact.py.

Each port wrapper starts from the JAX wrapper's state, carried across by
``online_gp_torch.convert`` (params, stem, old state; the optimizers start
fresh in both): the JAX wrapper's params are cast to float64 first (its
optimizers made anew), on float64 inputs, with an ``IdentityStem``. Then
both run one sequence: a 1-epoch ``fit``, 8 ``update()``s at q = 1,
``predict`` and ``evaluate``; params, state and predictions are compared
after the fit and after the updates, to rtol 1e-5 against each quantity's
largest entry (as tests/test_torch_regression.py states it: far below one
Adam step, far above the rounding of two LAPACKs).

- ``OnlineSGPRegression`` with ``rebase_every=4``: updates 4 and 8 take a
  bound step and rebase, the others accumulate exactly;
- ``OnlineSVGPRegression`` in both variational modes with the streaming
  correction, and ``OnlineSVGPClassifier``; the fits take minibatches of
  16 from the numpy permutation path (``batch_stream=False`` in both: the
  JAX package's default ring is its C++ loader when that builds);
- the "conjugate" ValueError of a closed-form classifier, and the
  ValueError of an unknown variational mode.
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


# -- SGPR -----------------------------------------------------------------------


def test_sgpr_matches_jax():
    tx, ty, ex, ey = _regression_data()
    kw = dict(num_inducing=16, lr=0.05, rebase_every=4)
    jr = japi.OnlineSGPRegression(japi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], **kw)
    jr.params = _f64(jr.params)
    jr.opt_state = jr.opt.init(jr.params)
    tr = tapi.OnlineSGPRegression(tapi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], device="cpu", **kw)
    convert.load_sgpr(tr, _host(jr.params), {}, {}, device="cpu")

    def compare(jr, tr, what):
        _tree_close(jr.params, tr.params, f"{what}: params")
        for name in ("z", "var_mean", "C", "c"):
            _close(getattr(jr.old, name), getattr(tr.old, name), f"{what}: old.{name}")
        _tree_close(jr.old.kernel_params, tr.old.kernel_params, f"{what}: old kernel")
        _close(jr.moments.var_mean, tr.moments.var_mean, f"{what}: moments mean")
        _close(jr.moments.var_chol, tr.moments.var_chol, f"{what}: moments factor")
        assert jr._absorbs_since_rebase == tr._absorbs_since_rebase

    _run(jr, tr, tx, ty, compare)
    for a, b in zip(jr.predict(ex), tr.predict(ex)):
        _close(a, b, "predict")
    _close(jr.evaluate(ex, ey), tr.evaluate(ex, ey), "evaluate")


# -- SVGP -----------------------------------------------------------------------


def _svgp_pair(cls, tx, ty, **kw):
    jr = getattr(japi, cls)(japi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], num_inducing=16, lr=0.05, **kw)
    jr.params = _f64(jr.params)
    jr.opt_state = jr.opt.init(jr.params)
    tr = getattr(tapi, cls)(tapi.IdentityStem(2), tx[:N_INIT], ty[:N_INIT], num_inducing=16, lr=0.05,
                            device="cpu", **kw)
    convert.load_svgp(tr, _host(jr.params), {}, {}, device="cpu")
    return jr, tr


def _svgp_compare(jr, tr, what):
    _tree_close(jr.params, tr.params, f"{what}: params")
    assert (jr.old is None) == (tr.old is None)
    if jr.old is not None:
        for name in jr.old._fields:
            _close(getattr(jr.old, name), getattr(tr.old, name), f"{what}: old.{name}")


@pytest.mark.parametrize("mode", ["grad", "closed_form"])
def test_svgp_regression_matches_jax(mode):
    tx, ty, ex, ey = _regression_data()
    jr, tr = _svgp_pair("OnlineSVGPRegression", tx, ty, streaming=True, prior_beta=1e-3, online_beta=1e-3,
                        variational_mode=mode)
    _run(jr, tr, tx, ty, _svgp_compare, dict(batch_size=16, batch_stream=False))
    for a, b in zip(jr.predict(ex), tr.predict(ex)):
        _close(a, b, "predict")
    _close(jr.evaluate(ex, ey), tr.evaluate(ex, ey), "evaluate")
    _close(jr.noise, tr.noise, "noise")


def test_svgp_classifier_matches_jax():
    tx, ty, ex, ey = _classification_data()
    jr, tr = _svgp_pair("OnlineSVGPClassifier", tx, ty, streaming=True)
    _run(jr, tr, tx, ty, _svgp_compare, dict(batch_size=16, batch_stream=False))
    (jl, jp), (tl, tp) = jr.predict(ex), tr.predict(ex)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    _close(jp, tp, "p(y = 1)")
    _close(jr.evaluate(ex, ey), tr.evaluate(ex, ey), "accuracy")


def test_svgp_mode_errors():
    x, y = np.zeros((20, 2)), np.zeros(20, np.int32)
    with pytest.raises(ValueError, match="conjugate"):
        tapi.OnlineSVGPClassifier(tapi.IdentityStem(2), x, y, variational_mode="closed_form", device="cpu")
    with pytest.raises(ValueError, match="grad/closed_form"):
        tapi.OnlineSVGPRegression(tapi.IdentityStem(2), x, y[:, None], variational_mode="natural", device="cpu")


@pytest.mark.parametrize("cls", ["OnlineExactRegression", "OnlineExactClassifier", "OnlineLocalGPRegression",
                                 "OnlineSGPRegression", "OnlineSVGPRegression", "OnlineSVGPClassifier"])
def test_the_default_device_is_the_card_with_no_cpu_fallback(cls):
    """Constructed without ``device=``, a wrapper asks for CUDA; without a
    card that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    x = np.zeros((8, 2))
    y = np.zeros(8, np.int64) if "Classifier" in cls else np.zeros((8, 1))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        getattr(tapi, cls)(tapi.IdentityStem(2), x, y)
