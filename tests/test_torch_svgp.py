"""The port's O-SVGP core (``online_gp_torch/models/svgp.py``) against the
JAX package's, at float64.

Every function of the module runs on the same inputs in both packages (the
JAX ones jitted, the model static): values to rtol 1e-10, and the
gradients of ``svgp_elbo`` (Gaussian and probit) and of
``svgp_streaming_correction`` for every leaf to 1e-8 of that leaf's
largest entry. Then the properties the JAX package's own tests check
(tests/models/test_svgp_sgpr.py): the KL of the prior init is 0, the
self-KL of a snapshot is 0, the E-step is ELBO-optimal and equals Bui's
update from the prior, an indefinite Gram and a singular projected
covariance stay finite, the Gaussian expected log-likelihood's noise
floor, and ``zero_nans`` (NaN entries of a gradient become 0, +-Inf pass)
against optax's own optimizer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from online_gp_tpu.api.svgp import _make_optimizer as j_make_optimizer
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import svgp as js
from online_gp_torch import convert
from online_gp_torch.api import IdentityStem, OnlineSVGPRegression
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import svgp as ts

VAL_TOL = 1e-10
GRAD_TOL = 1e-8
M, D = 12, 2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jitted(name, **static):
    return jax.jit(functools.partial(getattr(js, name), **static), static_argnums=(0,))


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, tol=VAL_TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * max(np.max(np.abs(_np(want))), 1e-300),
                               err_msg=what)


def _tree_close(want, got, tol=VAL_TOL):
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(v, got[k], tol)
        else:
            _close(v, got[k], tol, k)


def _models(likelihood="gaussian", constant_mean=False):
    return (js.SVGPModel(JRBF(), likelihood=likelihood, constant_mean=constant_mean),
            ts.SVGPModel(RBFKernel(), likelihood=likelihood, constant_mean=constant_mean))


def _params(rng, jm, likelihood="gaussian", constant_mean=False):
    """JAX params (float64) with every leaf moved off its init, and their
    torch copy."""
    z = rng.uniform(-1, 1, (M, D))
    p = jm.init_params(jnp.asarray(z), D, dtype=jnp.float64, lengthscale=0.5)
    p["kernel"]["raw_lengthscale"] = p["kernel"]["raw_lengthscale"] + jnp.asarray([0.1, -0.2])
    p["kernel"]["raw_outputscale"] = p["kernel"]["raw_outputscale"] + 0.3
    p["var_mean"] = jnp.asarray(rng.normal(size=M))
    chol = np.tril(0.1 * rng.normal(size=(M, M)), -1) + np.diag(rng.uniform(0.3, 0.8, M))
    chol[0, M - 1] = 0.7  # an upper entry, which every function reads through tril
    p["var_chol"] = jnp.asarray(chol)
    if likelihood == "gaussian":
        p["raw_noise"] = jnp.asarray(-1.2, jnp.float64)
    if constant_mean:
        p["mean_const"] = jnp.asarray(0.25, jnp.float64)
    return p, _torch(p)


def _torch(p):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _data(rng, n=30, binary=False):
    x = rng.uniform(-1.1, 1.1, (n, D))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)
    if binary:
        y = (y > 0).astype(np.float64)
    return x, y


def _grads_close(jloss, tloss, jp, tp):
    jg = jax.grad(jloss)(jp)
    leaves = {k: v for k, v in tp.items() if not isinstance(v, dict)}
    leaves.update({f"kernel/{k}": v for k, v in tp["kernel"].items()})
    for t in leaves.values():
        t.requires_grad_(True)
    tg = dict(zip(leaves, torch.autograd.grad(tloss(tp), list(leaves.values()), allow_unused=True)))
    for name, g in tg.items():
        want = jg["kernel"][name[7:]] if name.startswith("kernel/") else jg[name]
        if g is None:  # a leaf the loss does not read: JAX's gradient is 0
            g = torch.zeros_like(leaves[name])
        _close(want, g, GRAD_TOL, f"gradient of {name}")


def test_init_params_and_prior_init_match_jax():
    rng = np.random.default_rng(0)
    jm, tm = _models()
    z = rng.uniform(-1, 1, (M, D))
    jp = jm.init_params(jnp.asarray(z), D, dtype=jnp.float64)
    tp = tm.init_params(torch.tensor(z), D, dtype=torch.float64, device="cpu")
    _tree_close(jp, tp, 0.0)
    _tree_close(js.svgp_init_variational_to_prior(jm, jp), ts.svgp_init_variational_to_prior(tm, tp))


@pytest.mark.parametrize("constant_mean", [False, True])
def test_predict_kl_and_expected_log_prob_match_jax(constant_mean):
    rng = np.random.default_rng(1)
    jm, tm = _models(constant_mean=constant_mean)
    jp, tp = _params(rng, jm, constant_mean=constant_mean)
    x, y = _data(rng)
    for full_cov in (False, True):
        want = _jitted("svgp_predict", full_cov=full_cov)(jm, jp, jnp.asarray(x))
        got = ts.svgp_predict(tm, tp, torch.tensor(x), full_cov=full_cov)
        for a, b in zip(want, got):
            _close(a, b)
    _close(_jitted("svgp_kl_to_prior")(jm, jp), ts.svgp_kl_to_prior(tm, tp))
    mean, var = rng.normal(size=7), rng.uniform(0.1, 1.0, 7)
    for noise in (0.3, 1e-9):
        _close(js.gaussian_expected_log_prob(jnp.asarray(y[:7]), jnp.asarray(mean), jnp.asarray(var), noise),
               ts.gaussian_expected_log_prob(torch.tensor(y[:7]), torch.tensor(mean), torch.tensor(var),
                                             torch.tensor(noise, dtype=torch.float64)))


@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
def test_elbo_and_its_gradient_match_jax(likelihood):
    rng = np.random.default_rng(2)
    jm, tm = _models(likelihood)
    jp, tp = _params(rng, jm, likelihood)
    x, y = _data(rng, binary=likelihood == "bernoulli")
    n_data, beta = 200, 0.3
    jf = _jitted("svgp_elbo")
    _close(jf(jm, jp, jnp.asarray(x), jnp.asarray(y), n_data, beta),
           ts.svgp_elbo(tm, tp, torch.tensor(x), torch.tensor(y), n_data, beta))
    _grads_close(lambda p: jf(jm, p, jnp.asarray(x), jnp.asarray(y), n_data, beta),
                 lambda p: ts.svgp_elbo(tm, p, torch.tensor(x), torch.tensor(y), n_data, beta), jp, tp)


def test_snapshot_and_streaming_correction_with_gradient_match_jax():
    rng = np.random.default_rng(3)
    jm, tm = _models()
    jp, tp = _params(rng, jm)
    jold, told = _jitted("svgp_snapshot")(jm, jp), ts.svgp_snapshot(tm, tp)
    for a, b in zip(jold, told):
        _close(a, b)
    # the snapshot is a copy: moving the params in place leaves it
    with torch.no_grad():
        tp["z"] += 0.05
    _close(jold.z, told.z)
    jp2, tp2 = _params(np.random.default_rng(4), jm)
    jf = _jitted("svgp_streaming_correction")
    _close(jf(jm, jp2, jold, 3, 0.5), ts.svgp_streaming_correction(tm, tp2, told, 3, 0.5))
    _grads_close(lambda p: jf(jm, p, jold, 3, 0.5), lambda p: ts.svgp_streaming_correction(tm, p, told, 3, 0.5),
                 jp2, tp2)


@pytest.mark.parametrize("moved_z", [False, True])
def test_closed_form_update_and_estep_match_jax(moved_z):
    rng = np.random.default_rng(5)
    jm, tm = _models()
    jp, tp = _params(rng, jm)
    x, y = _data(rng, n=9)
    new_z = rng.uniform(-1, 1, (M + 3, D)) if moved_z else None
    want = _jitted("svgp_closed_form_update")(jm, jp, jnp.asarray(x), jnp.asarray(y),
                                              None if new_z is None else jnp.asarray(new_z))
    got = ts.svgp_closed_form_update(tm, tp, torch.tensor(x), torch.tensor(y),
                                     None if new_z is None else torch.tensor(new_z))
    _tree_close(want, got)
    _tree_close(_jitted("svgp_exact_estep")(jm, jp, jnp.asarray(x), jnp.asarray(y)),
                ts.svgp_exact_estep(tm, tp, torch.tensor(x), torch.tensor(y)))


# -- the JAX package's properties ---------------------------------------------


def _prior_params(tm, z, lengthscale=0.4):
    return ts.svgp_init_variational_to_prior(
        tm, tm.init_params(z, z.shape[1], dtype=torch.float64, device="cpu", lengthscale=lengthscale))


def _sine(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 1))
    return torch.tensor(x), torch.tensor(np.sin(3 * x[:, 0]) + 0.1 * rng.normal(size=n))


def test_prior_init_kl_is_zero():
    _, tm = _models()
    p = _prior_params(tm, torch.linspace(-1, 1, 12, dtype=torch.float64)[:, None])
    assert abs(float(ts.svgp_kl_to_prior(tm, p))) < 1e-2


def test_self_kl_of_a_snapshot_is_zero():
    """Right after a snapshot q_new(a) is q_old(a): KL[q_new || q_old] is 0,
    so the correction is -KL[q(a) || p(a)] * beta / n, up to the snapshot's
    1e-5 floors (on a well-conditioned K_zz: four corners, lengthscale 0.5)."""
    _, tm = _models()
    z = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]], dtype=torch.float64)
    p = tm.init_params(z, 2, dtype=torch.float64, device="cpu", lengthscale=0.5)
    p["var_mean"] = torch.tensor([0.3, -0.2, 0.5, 0.1], dtype=torch.float64)
    p["var_chol"] = torch.tensor([[0.6, 0, 0, 0], [0.1, 0.5, 0, 0], [0, 0.2, 0.7, 0], [0.1, 0, 0.1, 0.4]],
                                 dtype=torch.float64)
    old = ts.svgp_snapshot(tm, p)
    corr = float(ts.svgp_streaming_correction(tm, p, old, 4, 0.5))
    want = -float(ts.svgp_kl_to_prior(tm, p)) * 0.5 / 4
    assert np.isfinite(corr) and abs(corr - want) <= 1e-3 * abs(want)


def test_estep_is_elbo_optimal_and_equals_bui_from_the_prior():
    _, tm = _models()
    x, y = _sine(120, 0)
    p0 = _prior_params(tm, torch.linspace(-1, 1, 12, dtype=torch.float64)[:, None])
    elbo = lambda p: float(ts.svgp_elbo(tm, p, x, y, x.shape[0], 1.0).detach())
    star = ts.svgp_exact_estep(tm, p0, x, y)
    assert elbo(star) > elbo(p0)
    p = {k: (v.clone().requires_grad_(k in ("var_mean", "var_chol")) if torch.is_tensor(v) else v)
         for k, v in p0.items()}
    opt = torch.optim.Adam([p["var_mean"], p["var_chol"]], lr=0.05)
    for _ in range(200):
        opt.zero_grad()
        (-ts.svgp_elbo(tm, p, x, y, x.shape[0], 1.0)).backward()
        opt.step()
    assert elbo(star) >= elbo(p) - 1e-3

    x, y = _sine(60, 0)
    p0 = _prior_params(tm, torch.linspace(-1, 1, 10, dtype=torch.float64)[:, None])
    a, b = ts.svgp_exact_estep(tm, p0, x, y), ts.svgp_closed_form_update(tm, p0, x, y)
    np.testing.assert_allclose(_np(a["var_mean"]), _np(b["var_mean"]), atol=5e-3)
    S = lambda q: _np(q["var_chol"] @ q["var_chol"].T)
    np.testing.assert_allclose(S(a), S(b), atol=5e-3)


def test_indefinite_gram_snapshot_keeps_the_correction_finite():
    gen = torch.Generator().manual_seed(7)
    centers = torch.tensor([[-0.5, 0.0], [0.4, 0.3], [0.1, -0.6]], dtype=torch.float32)
    z = centers[torch.arange(96) % 3] + 1e-3 * torch.randn((96, 2), generator=gen)
    tm = ts.SVGPModel(RBFKernel())
    p = ts.svgp_init_variational_to_prior(tm, tm.init_params(z, 2, device="cpu", lengthscale=1.0))
    x = torch.rand((64, 2), generator=gen) * 2 - 1
    y = torch.sin(2 * x[:, 0]) + 0.05 * torch.randn(64, generator=gen)
    p = ts.svgp_exact_estep(tm, p, x, y)
    old = ts.svgp_snapshot(tm, p)
    assert float(torch.linalg.eigvalsh(old.prior_cov.double()).min()) > 0.0
    assert float(torch.linalg.eigvalsh(old.var_cov.double()).min()) > 0.0
    corr = ts.svgp_streaming_correction(tm, ts.svgp_closed_form_update(tm, p, x[:1], y[:1]), old, 1, 1e-3)
    assert bool(torch.isfinite(corr))


def test_singular_projected_covariance_keeps_value_and_gradient_finite():
    _, tm = _models()
    x, _ = _sine(64, 0)
    x = x.float()
    tm = ts.SVGPModel(RBFKernel())
    p = ts.svgp_init_variational_to_prior(tm, tm.init_params(x[:32], 1, device="cpu", lengthscale=0.5))
    old = ts.svgp_snapshot(tm, p)
    p["var_chol"] = 1e-6 * torch.eye(32)
    leaves = [p["z"], p["var_mean"], p["var_chol"], p["raw_noise"], *p["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    val = ts.svgp_streaming_correction(tm, p, old, 4, 1.0)
    assert bool(torch.isfinite(val))
    for g in torch.autograd.grad(val, leaves, allow_unused=True):
        assert g is None or bool(torch.isfinite(g).all())


def test_expected_log_prob_noise_floor():
    raw = torch.tensor(-200.0, requires_grad=True)
    ell = torch.sum(ts.gaussian_expected_log_prob(torch.tensor([0.5]), torch.tensor([0.4]), torch.tensor([0.1]),
                                                  torch.exp(raw)))
    (g,) = torch.autograd.grad(ell, [raw])
    assert bool(torch.isfinite(ell)) and bool(torch.isfinite(g))


def test_zero_nans_zeroes_nan_and_passes_inf_as_optax():
    """One step of the wrapper's online GP optimizer against optax's chain
    (``zero_nans`` then the grouped Adam) on a gradient with a NaN leaf and
    an Inf entry: the NaN leaf does not move, the Inf reaches Adam (and
    makes its entry NaN in both), the healthy leaves step alike."""
    reg = OnlineSVGPRegression(IdentityStem(2), np.zeros((4, 2)), np.zeros((4, 1)), num_inducing=4, lr=0.01,
                               device="cpu")
    jparams = {"z": jnp.ones((4, 2)), "var_mean": jnp.zeros((4,)), "var_chol": jnp.eye(4),
               "kernel": {"raw_lengthscale": jnp.zeros((2,)), "raw_outputscale": jnp.zeros(())},
               "raw_noise": jnp.zeros(())}
    grads = jax.tree_util.tree_map(jnp.ones_like, jparams)
    grads["var_mean"] = jnp.full((4,), jnp.nan)
    grads["kernel"]["raw_lengthscale"] = jnp.asarray([1.0, jnp.inf])
    jopt = j_make_optimizer(0.01)
    up, _ = jopt.update(grads, jopt.init(jparams), jparams)
    want = optax.apply_updates(jparams, up)

    convert.load_svgp(reg, jax.tree_util.tree_map(np.asarray, jparams), {}, {}, device="cpu")
    tgrads = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, grads), "cpu")
    by_leaf = {id(reg.params[k]): tgrads[k] for k in ("z", "var_mean", "var_chol", "raw_noise")}
    by_leaf.update({id(reg.params["kernel"][k]): tgrads["kernel"][k] for k in tgrads["kernel"]})
    reg.opt.apply([by_leaf[id(p)] for p in reg.opt.leaves])
    assert bool(torch.isinf(reg.params["kernel"]["raw_lengthscale"].grad).any())
    for key in ("z", "var_mean", "var_chol", "raw_noise"):
        np.testing.assert_allclose(_np(reg.params[key]), np.asarray(want[key]), rtol=1e-6, atol=1e-9)
    for k in want["kernel"]:
        np.testing.assert_allclose(_np(reg.params["kernel"][k]), np.asarray(want["kernel"][k]), rtol=1e-6, atol=1e-9)
    assert bool((reg.params["var_mean"] == 0).all())
    assert bool(torch.isnan(reg.params["kernel"]["raw_lengthscale"][1]))


def test_jitter_scale_gradient_at_a_tie_matches_jax():
    """At a unit outputscale (raw 0: every kernel at init) mean |diag K_zz|
    is exactly 1, the tie of psd_safe_cholesky's max(mean |diag|, 1); JAX's
    jnp.maximum gives each side half the gradient there. The port's
    clamp passed it whole: here the KL's gradient in the outputscale was
    -4080.2159 against JAX's -4043.5267."""
    rng = np.random.default_rng(8)
    jm, tm = _models()
    jp, _ = _params(rng, jm)
    jp["kernel"]["raw_outputscale"] = jnp.zeros((), jnp.float64)
    jp["kernel"]["raw_lengthscale"] = jnp.full((D,), np.log(0.9))  # K_zz condition ~1e5
    tp = _torch(jp)
    jf = _jitted("svgp_kl_to_prior")
    _grads_close(lambda p: jf(jm, p), lambda p: ts.svgp_kl_to_prior(tm, p), jp, tp)
