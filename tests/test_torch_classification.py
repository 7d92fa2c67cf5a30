"""The port's Dirichlet classification against the JAX package's.

- ``dirichlet_transform`` and the Bernoulli probit pair at float64 (1e-12),
  and the transform bit for bit at its float32 default.
- ``OnlineSKIClassifier`` against the JAX classifier. The port's wrapper is
  started from the JAX one's params, stem and state (``convert``), both at
  float64 params (cast before the first step, optimizers made anew), on
  float64 inputs and one float64 grid (see ``_to_f64``). Then one
  sequence: three ``update()``s at q = 1, one at q = 4, ``absorb``, ``predict`` (labels equal), a 2-epoch ``fit`` and
  ``evaluate``, with ``IdentityStem`` at 3 classes and ``LinearStem`` at 2.
  Params, stem and roots to 1e-8. The Dirichlet targets and noise are
  float32 in both packages (the transform's default dtype), so y^T D^-1 y,
  log|D|, the losses that carry them and absorb's W^T D^-1 y (summed in the
  targets' dtype, as the JAX package's scatter-add casts) are float32
  sums: those are held to float32 rounding (1e-6 of their scale).
- The port's counterparts of tests/classification/test_ski_classifier.py::
  test_classifier_absorb_bulk_stream and the routes of
  tests/classification/test_lowrank_classifier.py:13,38, and the
  65,536-point ValueError of a directly constructed dense classifier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.api import IdentityStem as JIdentity
from online_gp_tpu.api import LinearStem as JLinear
from online_gp_tpu.api.classification import OnlineSKIClassifier as JClassifier
from online_gp_tpu.likelihoods import bernoulli as jbern
from online_gp_tpu.likelihoods.dirichlet import dirichlet_transform as j_dirichlet
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.api import IdentityStem, LinearStem, OnlineSKIClassifier, OnlineSKILowRankClassifier
from online_gp_torch.data import banana_dataset
from online_gp_torch.likelihoods import (
    bernoulli_probit_expected_log_prob,
    bernoulli_probit_predictive,
    dirichlet_transform,
)

TOL = 1e-8
F32_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
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


def test_dirichlet_transform_matches_jax():
    labels = np.array([0, 2, 1, 1, 0, 2, 2])
    for eps in (0.01, 0.1):
        for a, b in zip(j_dirichlet(jnp.asarray(labels), 3, eps, dtype=jnp.float64),
                        dirichlet_transform(torch.tensor(labels), 3, eps, dtype=torch.float64)):
            assert b.shape == (7, 3) and b.dtype == torch.float64
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)
        for a, b in zip(j_dirichlet(jnp.asarray(labels), 3, eps), dirichlet_transform(torch.tensor(labels), 3, eps)):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_bernoulli_probit_matches_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 50).astype(np.float64)
    mean, var = rng.normal(scale=3.0, size=50), rng.uniform(0.0, 4.0, 50)
    var[0] = 0.0  # the variance floor
    want = jbern.bernoulli_probit_expected_log_prob(jnp.asarray(y), jnp.asarray(mean), jnp.asarray(var))
    got = bernoulli_probit_expected_log_prob(torch.tensor(y), torch.tensor(mean), torch.tensor(var))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    want = jbern.bernoulli_probit_predictive(jnp.asarray(mean), jnp.asarray(var))
    got = bernoulli_probit_predictive(torch.tensor(mean), torch.tensor(var))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def _classes(n, C, seed=0):
    """Points in [-1, 1]^2 labelled by angle sector (C classes), float64."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    angle = np.arctan2(x[:, 1], x[:, 0]) + np.pi
    labels = np.minimum((angle / (2 * np.pi) * C).astype(np.int64), C - 1)
    flip = rng.uniform(size=n) < 0.1
    labels[flip] = rng.integers(0, C, flip.sum())
    return x, labels


def _to_f64(jc, tc):
    """Both classifiers on one float64 grid, and the JAX one's params and
    stem at float64 with its optimizers made anew (``_carry_over`` then
    starts the port's from them). The wrappers build float32 grids: XLA
    fuses their points' float32 arithmetic under jit, so the JAX package's
    jitted K_uu parts from its own eager one (and from the port's) by
    float32 rounding, 1e-7 of the gradients."""
    f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
    grid = JGrid.create([(-1.1, 1.1)] * 2, jc.model.grid.sizes, dtype=jnp.float64)
    jc.model = jc.model._replace(grid=grid)
    jc._init_fn = jax.jit(lambda f, t, n: jw.wiski_init(jc.model, f, t, n))
    tc.model = tc.model._replace(grid=convert.grid_from_numpy(
        grid.sizes, np.asarray(grid.mins), np.asarray(grid.spacings), device="cpu"))
    jc.params = f64(jc.params)
    jc.gp_opt_state = jc.gp_opt.init(jc.params)
    jc.stem_params = f64(jc.stem_params)
    jc.stem_opt_state = jc.stem_opt.init(jc.stem_params)


def _carry_over(jc, tc):
    a = lambda t: jax.tree_util.tree_map(np.asarray, t)
    s = jc.state
    state = dict(wty=s.wty, ydy=s.ydy, mat=s.roots.mat, root=s.roots.root, inv_root=s.roots.inv_root,
                 d_logdet=s.d_logdet, num_data=s.num_data)
    convert.load_wrapper(tc, a(jc.params), a(jc.stem_params), a(jc.stem_state), a(state))


def _close_models(jc, tc, what):
    for key in ("raw_lengthscale", "raw_outputscale"):
        _close(jc.params["kernel"][key], tc.params["kernel"][key], f"{what}: {key}")
    assert tc.params["kernel"]["raw_lengthscale"].dtype == torch.float64
    if tc.stem.has_params:
        _close(np.asarray(jc.stem_params["lin"]["w"]).T, tc.stem.lin.weight, f"{what}: stem w")
        _close(jc.stem_params["lin"]["b"], tc.stem.lin.bias, f"{what}: stem b")
        _close(jc.stem_state["bn"]["mean"], tc.stem.bn.running_mean, f"{what}: bn mean")
        _close(jc.stem_state["bn"]["var"], tc.stem.bn.running_var, f"{what}: bn var")
    js, ts = jc.state, tc.state
    for name, tol in (("wty", F32_TOL), ("ydy", F32_TOL), ("d_logdet", F32_TOL)):
        _close(getattr(js, name), getattr(ts, name), f"{what}: {name}", tol)
    for name in ("mat", "root", "inv_root"):
        _close(getattr(js.roots, name), getattr(ts.roots, name), f"{what}: {name}")
    assert int(js.num_data) == ts.num_data
    assert ts.wty.dtype == torch.float64


@pytest.mark.parametrize("stem,C", [("identity", 3), ("linear", 2)])
def test_classifier_sequence_matches_jax(stem, C):
    x, labels = _classes(160, C)
    jstem, tstem = (JIdentity(2), IdentityStem(2)) if stem == "identity" else (JLinear(2, 2), LinearStem(2, 2))
    kw = dict(alpha_eps=0.01, lr=0.05, grid_size=10, grid_bound=1.0, num_classes=C)
    jc = JClassifier(jstem, x[:40], labels[:40], **kw)
    tc = OnlineSKIClassifier(tstem, x[:40], labels[:40], device="cpu", **kw)
    assert type(tc) is OnlineSKIClassifier and tc.model.num_outputs == C and not tc.model.learn_additional_noise
    _to_f64(jc, tc)
    _carry_over(jc, tc)
    _close_models(jc, tc, "carried over")

    for lo, hi in ((40, 41), (41, 42), (42, 43), (43, 47)):
        got, want = tc.update(x[lo:hi], labels[lo:hi]), jc.update(x[lo:hi], labels[lo:hi])
        _close(want, got, f"update losses [{lo}:{hi})", F32_TOL)
        _close_models(jc, tc, f"after update [{lo}:{hi})")
    jc.absorb(x[47:70], labels[47:70])
    tc.absorb(x[47:70], labels[47:70])
    _close_models(jc, tc, "after absorb")
    pred = tc.predict(x[100:160])
    assert pred.dtype == torch.int64 and pred.shape == (60,)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jc.predict(x[100:160])))

    jrec, trec = jc.fit(x[:70], labels[:70], 2, test_dataset=(x[100:160], labels[100:160])), \
        tc.fit(x[:70], labels[:70], 2, test_dataset=(x[100:160], labels[100:160]))
    _close([r["train_loss"] for r in jrec], [r["train_loss"] for r in trec], "fit losses", F32_TOL)
    # the same labels predicted: accuracies equal up to float32 means
    assert [r["test_acc"] for r in trec] == pytest.approx([r["test_acc"] for r in jrec], abs=1e-6)
    _close_models(jc, tc, "after fit")
    np.testing.assert_array_equal(tc.predict(x[100:160]).numpy(), np.asarray(jc.predict(x[100:160])))
    assert tc.evaluate(x[100:160], labels[100:160]) == pytest.approx(jc.evaluate(x[100:160], labels[100:160]),
                                                                     abs=1e-6)


def test_classifier_absorb_bulk_stream():
    """absorb() equals the update() conditioning channel (the port's
    tests/classification/test_ski_classifier.py::test_classifier_absorb_bulk_stream)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (96, 2)).astype(np.float32)
    labels = (x[:, 0] * x[:, 1] > 0).astype(np.int32)
    a = OnlineSKIClassifier(IdentityStem(2), x[:32], labels[:32], grid_size=8, device="cpu")
    b = OnlineSKIClassifier(IdentityStem(2), x[:32], labels[:32], grid_size=8, device="cpu")
    a.absorb(x[32:], labels[32:])
    for i in range(32, 96):
        b.update(x[i : i + 1], labels[i : i + 1], update_stem=False, update_gp=False)
    np.testing.assert_allclose(_np(a.state.roots.root), _np(b.state.roots.root), rtol=1e-4, atol=1e-5)
    assert a.state.num_data == b.state.num_data
    acc_a, acc_b = a.evaluate(x, labels), b.evaluate(x, labels)
    assert abs(acc_a - acc_b) < 0.05 and acc_a > 0.7


def test_routes_and_the_grid_limit():
    tr_x, tr_y, _, _ = banana_dataset(seed=0)
    w = OnlineSKIClassifier(IdentityStem(2), tr_x[:64], tr_y[:64], grid_size=16, low_rank=64, device="cpu")
    assert isinstance(w, OnlineSKILowRankClassifier)
    assert w.model.rank == 64 and w.device.type == "cpu" and w.state.root.device.type == "cpu"
    w = OnlineSKIClassifier(IdentityStem(2), tr_x[:64], tr_y[:64], grid_size=72, device="cpu")
    assert isinstance(w, OnlineSKILowRankClassifier) and w.model.rank == 512
    assert type(OnlineSKIClassifier(IdentityStem(2), tr_x[:64], tr_y[:64], grid_size=16, device="cpu")) \
        is OnlineSKIClassifier

    class Direct(OnlineSKIClassifier):  # constructed directly: no routing
        pass

    class JDirect(JClassifier):
        pass

    with pytest.raises(ValueError, match="infeasible"):
        JDirect(JIdentity(2), tr_x[:8], tr_y[:8], grid_size=257)
    with pytest.raises(ValueError, match="infeasible"):
        Direct(IdentityStem(2), tr_x[:8], tr_y[:8], grid_size=257, device="cpu")
