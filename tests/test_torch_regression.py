"""The port's ``OnlineSKIRegression`` (dense path) against the JAX wrapper.

The two wrappers start from the same point: the torch wrapper's stem,
params and state are carried across from the JAX one's by
``online_gp_torch.convert``. Then both run one sequence: 3 ``update()``s,
``hyper_step``, ``predict``, ``prequential``, ``absorb``, ``fit`` for 2
epochs, ``evaluate`` and ``mll_value``. The inputs are float64, so the state
is float64 while the params stay float32 in both, as in JAX. Tolerance:
rtol 1e-5 against each quantity's largest entry. The params are float32
and each step is an Adam step in float32, so the two drift by float32
rounding of the params (a few 1e-7 relative over the sequence); 1e-5 leaves
a 10x margin and is far below one Adam step (lr 0.05).

At float32 inputs ``fit`` diverges in one place, and it is the reference's
own behaviour: the stem's bias sits right before a train-mode BatchNorm, so
its exact gradient is 0 and the computed one is rounding noise, which
Adam's first step turns into +-lr. ``test_fit_stem_bias_gradient_is_rounding_noise``
shows it (ROADMAP Queue 3).

Then the port's counterparts of tests/regression/test_ski_regression.py::
test_update_returns_losses and ::test_prequential_matches_predict_then_absorb
and tests/regression/test_update_flags.py::test_update_gp_false_freezes_hypers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.api import IdentityStem as JIdentity
from online_gp_tpu.api import LinearStem as JLinear
from online_gp_tpu.api import OnlineSKIRegression as JRegression
from online_gp_tpu.data import sin_cos_dataset
from online_gp_torch import convert
from online_gp_torch.api import IdentityStem, LinearStem, OnlineSKIRegression, make_stem
from online_gp_torch.api.regression import cosine_lr
from online_gp_torch.kernels.base import make_kernel

RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    return sin_cos_dataset(n=600, seed=0)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, what):
    want, got = np.asarray(_np(want), np.float64), np.asarray(_np(got), np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _carry_over(jr, tr):
    """Load the JAX wrapper's stem, params and state into the torch one (in
    place, so its optimizers keep their parameters)."""
    a = lambda v: None if v is None else np.asarray(v)
    if tr.stem.has_params:
        convert.stem_from_numpy(tr.stem, jax.tree_util.tree_map(a, jr.stem_params),
                                jax.tree_util.tree_map(a, jr.stem_state), device="cpu")
    with torch.no_grad():
        for key in ("raw_lengthscale", "raw_outputscale"):
            tr.params["kernel"][key].copy_(torch.tensor(a(jr.params["kernel"][key])))
        tr.params["raw_second_noise"].copy_(torch.tensor(a(jr.params["raw_second_noise"])))
    s = jr.state
    tr.state = convert.state_from_numpy(a(s.wty), a(s.ydy), a(s.roots.mat), a(s.roots.root), a(s.roots.inv_root),
                                        a(s.d_logdet), a(s.num_data), device="cpu")


def _close_models(jr, tr, what):
    _close(jr.params["kernel"]["raw_lengthscale"], tr.params["kernel"]["raw_lengthscale"], f"{what}: lengthscale")
    _close(jr.params["kernel"]["raw_outputscale"], tr.params["kernel"]["raw_outputscale"], f"{what}: outputscale")
    _close(jr.params["raw_second_noise"], tr.params["raw_second_noise"], f"{what}: second noise")
    assert tr.params["raw_second_noise"].dtype == torch.float32
    if tr.stem.has_params:
        _close(np.asarray(jr.stem_params["lin"]["w"]).T, tr.stem.lin.weight, f"{what}: stem w")
        _close(jr.stem_params["lin"]["b"], tr.stem.lin.bias, f"{what}: stem b")
        _close(jr.stem_state["bn"]["mean"], tr.stem.bn.running_mean, f"{what}: bn mean")
        _close(jr.stem_state["bn"]["var"], tr.stem.bn.running_var, f"{what}: bn var")
    js, ts = jr.state, tr.state
    for name in ("wty", "ydy", "d_logdet"):
        _close(getattr(js, name), getattr(ts, name), f"{what}: {name}")
    _close(js.roots.root, ts.roots.root, f"{what}: root")
    _close(js.roots.inv_root, ts.roots.inv_root, f"{what}: inv_root")
    assert (js.roots.mat is None) == (ts.roots.mat is None)
    assert int(js.num_data) == ts.num_data
    assert ts.wty.dtype == torch.float64


@pytest.mark.parametrize("stem,options", [
    ("linear", dict()),
    ("identity", dict(slim_state=True, refresh_roots_every=16, kernel="matern32")),
])
def test_wrapper_sequence_matches_jax(data, stem, options):
    tx, ty, *_ = data
    tx, ty = tx.astype(np.float64), ty.astype(np.float64)
    jstem, tstem = (JLinear(2, 2), LinearStem(2, 2)) if stem == "linear" else (JIdentity(2), IdentityStem(2))
    kw = dict(lr=0.05, grid_size=10, grid_bound=1.0, **options)
    jr = JRegression(jstem, tx[:40], ty[:40], **kw)
    tr = OnlineSKIRegression(tstem, tx[:40], ty[:40], device="cpu", **kw)
    _carry_over(jr, tr)

    for i in range(40, 43):
        _close(jr.update(tx[i : i + 1], ty[i : i + 1]), tr.update(tx[i : i + 1], ty[i : i + 1]), f"update {i}")
    _close_models(jr, tr, "after 3 updates")
    _close(jr.hyper_step(tx[43:46], ty[43:46]), tr.hyper_step(tx[43:46], ty[43:46]), "hyper_step")
    for a, b in zip(jr.predict(tx[100:130]), tr.predict(tx[100:130])):
        _close(a, b, "predict")
    for a, b in zip(jr.prequential(tx[46:70], ty[46:70]), tr.prequential(tx[46:70], ty[46:70])):
        _close(a, b, "prequential")
    jr.absorb(tx[70:90], ty[70:90])
    tr.absorb(tx[70:90], ty[70:90])
    _close_models(jr, tr, "after absorb")
    jrec, trec = jr.fit(tx[:90], ty[:90], 2), tr.fit(tx[:90], ty[:90], 2)
    for key in ("train_loss", "noise"):
        _close([r[key] for r in jrec], [r[key] for r in trec], f"fit {key}")
    _close_models(jr, tr, "after fit")
    _close(jr.evaluate(tx[100:130], ty[100:130]), tr.evaluate(tx[100:130], ty[100:130]), "evaluate")
    _close(jr.mll_value(), tr.mll_value(), "mll_value")
    _close(jr.noise, tr.noise, "noise")


def test_fit_stem_bias_gradient_is_rounding_noise(data):
    """Why fit is compared at float64 inputs: with float32 inputs the first
    fit epoch's gradient of the stem's bias (before a train-mode BatchNorm,
    which subtracts the batch mean) is 0 in exact arithmetic, and in both
    packages it is rounding noise, 1e-6 of the weight's gradient or less.
    Adam's first step is lr * sign(g), so the two packages' biases part by up
    to 2 lr there. Both wrappers show it; neither is at fault."""
    tx, ty, *_ = data
    jr = JRegression(JLinear(2, 2), tx[:90], ty[:90], lr=0.05, grid_size=10)
    tr = OnlineSKIRegression(LinearStem(2, 2), tx[:90], ty[:90], lr=0.05, grid_size=10, device="cpu")
    _carry_over(jr, tr)
    from online_gp_tpu.models.wiski import wiski_init as jinit, wiski_mll as jmll
    from online_gp_torch.models.wiski import wiski_init, wiski_mll

    x, y = jnp.asarray(tx[:90]), jnp.asarray(ty[:90])

    def jloss(sp):
        feats, _ = jr.stem.apply(sp, jr.stem_state, x, train=True)
        return -jnp.sum(jmll(jr.model, jr.params, jinit(jr.model, feats, y, jnp.ones_like(y))))

    jg = jax.jit(jax.grad(jloss))(jr.stem_params)["lin"]
    tr.stem.train()
    yt = torch.tensor(ty[:90])
    loss = -torch.sum(wiski_mll(tr.model, tr.params, wiski_init(tr.model, tr.stem(torch.tensor(tx[:90])), yt,
                                                                torch.ones_like(yt))))
    gw, gb = torch.autograd.grad(loss, [tr.stem.lin.weight, tr.stem.lin.bias])
    for w, b in ((np.asarray(jg["w"]), np.asarray(jg["b"])), (gw.numpy(), gb.numpy())):
        assert np.max(np.abs(b)) <= 1e-6 * np.max(np.abs(w))
    # the weight's gradient agrees to float32 rounding, amplified through the
    # Cholesky factors of a float32 state
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg["w"]).T, rtol=1e-3)


def test_update_returns_losses(data):
    tr_x, tr_y, *_ = data
    reg = OnlineSKIRegression(IdentityStem(2), tr_x[:30], tr_y[:30], lr=0.01, grid_size=12, grid_bound=1.0,
                              device="cpu")
    s_loss, g_loss = reg.update(tr_x[30:31], tr_y[30:31])
    assert np.isfinite(g_loss)
    # the identity stem has no parameters, so its loss is reported as 0
    assert s_loss == 0.0


def test_prequential_matches_predict_then_absorb(data):
    """prequential(): per-point predictions equal predict() on the prefix
    posterior, and the absorbed state matches absorb()'s."""
    tr_x, tr_y, *_ = data
    mk = lambda: OnlineSKIRegression(IdentityStem(2), tr_x[:40], tr_y[:40], lr=0.05, grid_size=12,
                                     grid_bound=1.0, device="cpu")
    a, b = mk(), mk()
    stream_x, stream_y = tr_x[40:61], tr_y[40:61]
    mean_pq, var_pq = a.prequential(stream_x, stream_y)
    means, vars_ = [], []
    for i in range(stream_x.shape[0]):
        m_i, v_i = b.predict(stream_x[i : i + 1])
        means.append(_np(m_i))
        vars_.append(_np(v_i))
        b.absorb(stream_x[i : i + 1], stream_y[i : i + 1])
    np.testing.assert_allclose(_np(mean_pq), np.concatenate(means), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(var_pq), np.concatenate(vars_), atol=1e-5, rtol=1e-5)
    # float32 state: the blocked and per-point recursions differ by rounding
    np.testing.assert_allclose(_np(a.state.roots.root), _np(b.state.roots.root), atol=1e-4)
    assert a.state.num_data == b.state.num_data == 61
    # follow-up predicts ride the conditioned caches and agree
    for u, v in zip(a.predict(stream_x[:5]), b.predict(stream_x[:5])):
        np.testing.assert_allclose(_np(u), _np(v), atol=1e-5)


def test_update_gp_false_freezes_hypers():
    tx, ty, *_ = sin_cos_dataset(n=200)
    r = OnlineSKIRegression(LinearStem(2, 2), tx[:50], ty[:50], lr=0.05, grid_size=10, grid_bound=1.0,
                            device="cpu")
    leaves = lambda: [t.detach().clone() for t in (r.params["kernel"]["raw_lengthscale"],
                                                    r.params["kernel"]["raw_outputscale"],
                                                    r.params["raw_second_noise"], *r.stem.parameters())]
    before = leaves()
    r.update(tx[50:51], ty[50:51], update_stem=False, update_gp=False)
    # conditioning happened, but neither parameter set moved
    assert r.state.num_data == 51
    assert all(torch.equal(a, b) for a, b in zip(before, leaves()))
    r.update(tx[51:52], ty[51:52], update_stem=True, update_gp=True)
    assert not all(torch.equal(a, b) for a, b in zip(before, leaves()))


def test_conditioning_only_update_keeps_the_predictive_caches(data):
    """After update(update_stem=False, update_gp=False) the caches are
    conditioned in O(m^2), not rebuilt, and predict agrees with a rebuild."""
    tx, ty, *_ = data
    r = OnlineSKIRegression(LinearStem(2, 2), tx[:50], ty[:50], lr=0.05, grid_size=10, device="cpu")
    r.predict(tx[100:105])
    r.update(tx[50:52], ty[50:52], update_stem=False, update_gp=False)
    assert r._pred_caches is not None
    kept = r.predict(tx[100:110])
    r._pred_caches = None
    for a, b in zip(kept, r.predict(tx[100:110])):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    r.update(tx[52:53], ty[52:53])
    assert r._pred_caches is None  # the hypers moved


def test_options_the_port_does_not_have_raise(data):
    """What the port has no counterpart for raises: an unknown kernel. Since
    the large-grid slice, low_rank=, grids above DENSE_GRID_LIMIT and the
    spectral-mixture names no longer raise: they route to the rank-capped
    wrapper and build the kernel; since the grid-sharded slice a sharded
    grid's config constructs."""
    from online_gp_torch.api import OnlineSKILowRankRegression
    from online_gp_torch.config import SolverConfig
    from online_gp_torch.kernels.spectral_mixture import SpectralMixtureKernel

    tx, ty, *_ = data
    with pytest.raises(ValueError, match="unknown kernel"):
        make_kernel("periodic")
    assert SolverConfig(grid_shard_axis="tp").grid_shard_axis == "tp"
    r = OnlineSKIRegression(LinearStem(2, 2), tx[:20], ty[:20], low_rank=64, device="cpu")
    assert isinstance(r, OnlineSKILowRankRegression) and r.model.rank == 64
    r = OnlineSKIRegression(make_stem("identity", 2), tx[:20], ty[:20], grid_size=65, device="cpu")
    assert isinstance(r, OnlineSKILowRankRegression) and r.model.grid.num_points == 65**2
    for name in ("sm3", "spectral_mixture"):
        assert isinstance(make_kernel(name), SpectralMixtureKernel)


def test_set_lr_and_cosine_schedule(data):
    import optax

    tx, ty, *_ = data
    r = OnlineSKIRegression(LinearStem(2, 2), tx[:30], ty[:30], lr=0.02, grid_size=10, device="cpu")
    r.set_lr(0.03, stem_lr=0.004, bn_mom=0.3)
    assert r.gp_opt.param_groups[0]["lr"] == 0.03 and r.stem_opt.param_groups[0]["lr"] == 0.004
    assert float(r.stem.bn.momentum) == pytest.approx(0.3)
    sched = optax.cosine_decay_schedule(0.02, 5, alpha=1e-4 / 0.02)
    for t in range(7):
        assert cosine_lr(0.02, 5, t) == pytest.approx(float(sched(t)), rel=1e-6)


def test_cpu_wrapper_never_touches_launch_counters(data):
    """On the CPU every kernel's plain version runs: the training path through
    the wrapper launches nothing."""
    from test_torch_wiski import _launch_counts

    before = _launch_counts()
    tx, ty, *_ = data
    r = OnlineSKIRegression(LinearStem(2, 2), tx[:40], ty[:40], grid_size=8, slim_state=True, device="cpu")
    r.fit(tx[:40], ty[:40], 1)
    r.update(tx[40:41], ty[40:41])
    r.update(tx[41:44], ty[41:44])
    r.hyper_step(tx[44:45], ty[44:45])
    r.predict(tx[45:50])
    r.prequential(tx[50:60], ty[50:60])
    r.absorb(tx[60:70], ty[60:70])
    assert np.isfinite(r.mll_value())
    assert _launch_counts() == before
