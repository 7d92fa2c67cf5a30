"""The BO loop of the port against the JAX package's, and the bars of the
JAX package's BayesOpt and active-learning tests on the port.

- ``make_fit_fn`` (Adam and L-BFGS) from a converted JAX state of the
  loop's reference surrogate at float64: params to 1e-6, last loss to 1e-8.
- One whole BO step from that state: the refit, then analytic qUCB and qEI
  optimized from the same Sobol starts (candidates and best values to
  1e-6, the value at the port's candidate to JAX's there to 1e-8), then the
  conditioning on the candidate (state to 1e-7).
- A checkpoint written by the JAX package's ``run_bayesopt`` /
  ``save_pytree``: loaded by the port (the same arrays, NamedTuples mapped
  to the port's, ``num_data`` an int) and resumed by the port's
  ``run_bayesopt``; the port's own checkpoint round trip.
- The bars of tests/bayesopt/test_bayesopt.py (:93, :154, :164, :239, :260)
  and tests/bayesopt/test_active_learning.py (all three), at those tests'
  sizes, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.bayesopt import acquisitions as jacq
from online_gp_tpu.bayesopt import loop as jloop
from online_gp_tpu.bayesopt import optimize as jopt
from online_gp_tpu.config import SolverConfig as JConfig
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_tpu.utils import checkpoint as jckpt
from online_gp_torch import convert
from online_gp_torch.bayesopt import acquisitions as tacq
from online_gp_torch.bayesopt import loop as tloop
from online_gp_torch.bayesopt import optimize as topt
from online_gp_torch.bayesopt.active_learning import run_active_learning
from online_gp_torch.bayesopt.mpv_osvgp import run_mpv_osvgp
from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import wiski as tw
from online_gp_torch.utils.checkpoint import load_pytree, save_pytree
from online_gp_torch.utils.optim import tree_leaves

ITER_TOL = 1e-6
VAL_TOL = 1e-8

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _close(got, want, tol=VAL_TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _close_tree(got, want, tol, what):
    for k, v in want.items():
        if isinstance(v, dict):
            _close_tree(got[k], v, tol, f"{what}/{k}")
        else:
            _close(got[k], v, tol, f"{what}/{k}")


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.detach().numpy() for k, v in tree.items()}


def _close_state(ts, js, tol=VAL_TOL):
    for f in ("wty", "ydy", "d_logdet"):
        _close(getattr(ts, f), getattr(js, f), tol, f)
    for f in ("mat", "root", "inv_root"):
        _close(getattr(ts.roots, f), getattr(js.roots, f), tol, f)
    assert ts.num_data == int(js.num_data)


def _surrogates(dim=2, grid_size=8):
    """The loop's reference surrogate in both packages, on float64 grids."""
    jm, _ = jloop._make_surrogate("reference", dim, grid_size, 0.1)
    jg = JGrid.create([(-0.05, 1.05)] * dim, grid_size, dtype=jnp.float64)
    jm = jm._replace(grid=jg)
    tm, noise_value = tloop._make_surrogate("reference", dim, grid_size, 0.1, device="cpu")
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    return jm, tm._replace(grid=tg), noise_value


@pytest.fixture(scope="module")
def bo_state():
    jm, tm, noise_value = _surrogates()
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 1, (10, 2))
    y = np.cos(5 * u[:, :1]) * np.sin(3 * u[:, 1:]) + 0.05 * rng.normal(size=(10, 1))
    y = (y - y.mean()) / y.std()
    noise = np.full_like(y, noise_value)
    js = jax.jit(jw.wiski_init, static_argnums=0)(jm, jnp.asarray(u), jnp.asarray(y), jnp.asarray(noise))
    ts = convert.state_from_numpy(np.asarray(js.wty), np.asarray(js.ydy), np.asarray(js.roots.mat),
                                  np.asarray(js.roots.root), np.asarray(js.roots.inv_root), np.asarray(js.d_logdet),
                                  int(js.num_data), device="cpu")
    jp = jm.init_params(2, dtype=jnp.float64)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp, js, ts, y, noise_value


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_make_fit_fn_matches(bo_state, method):
    jm, tm, jp, tp, js, ts, _, _ = bo_state
    jcfg, tcfg = JConfig(use_toeplitz=True), SolverConfig(use_toeplitz=True)
    iters = 10 if method == "adam" else 5
    jopt_, jfit = jloop.make_fit_fn(jm, jcfg, method, iters, 0.05)
    jp2, _, jlast = jfit(jp, js, jopt_.init(jp))
    tinit, tfit = tloop.make_fit_fn(tm, tcfg, method, iters, 0.05)
    tp2, _, tlast = tfit(tp, ts, tinit(tp))
    _close_tree(tp2, jax.tree_util.tree_map(np.asarray, jp2), ITER_TOL, "params")
    _close(tlast, jlast, VAL_TOL, "last loss")
    assert not any(p.requires_grad for p in tree_leaves(tp2))


@pytest.mark.parametrize("acqf", ["ucb", "ei"])
def test_one_bo_step_matches(bo_state, acqf):
    jm, tm, jp, tp, js, ts, y, noise_value = bo_state
    jcfg, tcfg = JConfig(use_toeplitz=True), SolverConfig(use_toeplitz=True)
    jo, jfit = jloop.make_fit_fn(jm, jcfg, "adam", 10, 0.05)
    jp2, _, _ = jfit(jp, js, jo.init(jp))
    tinit, tfit = tloop.make_fit_fn(tm, tcfg, "adam", 10, 0.05)
    tp2, _, _ = tfit(tp, ts, tinit(tp))

    raw = np.asarray(jopt.sobol_raw_init(1, 2, 32, 3), np.float64)
    bounds = np.array([[0.0, 1.0]] * 2)
    best_f, key = float(y.max()), jax.random.PRNGKey(1)

    @jax.jit
    def jstep(p, s, raw):
        if acqf == "ucb":
            f = lambda X: jacq.q_upper_confidence_bound(jm, p, s, X, 0.9, key, 128, jcfg)
        else:
            f = lambda X: jacq.q_expected_improvement(jm, p, s, X, jnp.asarray(best_f), key, 128, jcfg)
        return jopt.optimize_acqf(f, jnp.asarray(bounds), q=1, num_restarts=8, raw_samples=32, maxiter=100,
                                  key=key, raw_init=raw)

    jx, jv = jstep(jp2, js, jnp.asarray(raw))
    tp2_j = jax.tree_util.tree_map(jnp.asarray, _numpy_tree(tp2))
    if acqf == "ucb":
        jval = lambda X: jacq.q_upper_confidence_bound(jm, tp2_j, js, X, 0.9, key, 128, jcfg)
    else:
        jval = lambda X: jacq.q_expected_improvement(jm, tp2_j, js, X, jnp.asarray(best_f), key, 128, jcfg)
    tf = tloop.make_acquisition(acqf, tm, tp2, ts, tcfg, 1, torch.Generator().manual_seed(0), 1,
                                torch.tensor(best_f, dtype=torch.float64), torch.zeros((10, 2), dtype=torch.float64), 0.1)
    tx, tv = topt.optimize_acqf(tf, torch.tensor(bounds), q=1, num_restarts=8, raw_samples=32, maxiter=100,
                                raw_init=torch.tensor(raw))
    # the candidate and its value come out of 100 Adam steps (after 10 of
    # the refit): the iterate tolerance; the port's value at its candidate,
    # with its params, is JAX's acquisition there to 1e-8
    _close(tx, jx, ITER_TOL, "candidate")
    _close(tv, jv, ITER_TOL, "value")
    _close(tv, jax.jit(jval)(jnp.asarray(tx.numpy())), VAL_TOL, "value at the port's candidate")

    y_new = np.array([[0.7]])
    js2 = jax.jit(jw.wiski_condition, static_argnums=0)(jm, js, jx, jnp.asarray(y_new),
                                                         jnp.full((1, 1), noise_value))
    ts2 = tw.wiski_condition(tm, ts, tx, torch.tensor(y_new), torch.full((1, 1), noise_value, dtype=torch.float64))
    _close_state(ts2, js2, 1e-7)


def test_resume_from_a_jax_checkpoint(tmp_path):
    ckpt = str(tmp_path / "jax_campaign")
    first = jloop.run_bayesopt(function="Ackley", dim=2, acqf="ucb", num_steps=1, num_init=8, grid_size=8,
                               fit_iters=5, seed=0, verbose=False, checkpoint_path=ckpt)
    want = jckpt.load_pytree(ckpt)
    blob = load_pytree(ckpt, device="cpu")
    assert set(blob) == set(want)
    assert isinstance(blob["state"], tw.WiskiState) and isinstance(blob["state"].num_data, int)
    assert blob["surrogate"] == "reference"
    _close_tree(blob["params"], jax.tree_util.tree_map(np.asarray, want["params"]), 0, "params")
    _close_state(blob["state"], want["state"], 0)
    for k in ("train_u", "train_y", "latent", "best_per_step"):
        np.testing.assert_array_equal(blob[k].numpy(), np.asarray(want[k]))

    second = tloop.run_bayesopt(function="Ackley", dim=2, acqf="ucb", num_steps=2, num_init=8, grid_size=8,
                                fit_iters=5, seed=0, verbose=False, resume_from=ckpt, device="cpu")
    assert second["best_per_step"][:2] == first["best_per_step"]
    assert len(second["best_per_step"]) == 4
    bps = second["best_per_step"]
    assert all(b2 >= b1 - 1e-9 for b1, b2 in zip(bps, bps[1:]))
    assert second["state"].num_data == blob["state"].num_data + 2
    with pytest.raises(ValueError, match="surrogate"):
        tloop.run_bayesopt(function="Ackley", dim=2, num_steps=1, grid_size=8, surrogate="plain", verbose=False,
                           resume_from=ckpt, device="cpu")


def test_checkpoint_round_trip_and_exemplar_check(tmp_path, bo_state):
    _, _, _, tp, _, ts, _, _ = bo_state
    path = str(tmp_path / "ck")
    save_pytree(path, dict(params=tp, state=ts, tag="x", trace=[torch.arange(3), (1.5, None)]))
    back = load_pytree(path, device="cpu")
    _close_state(back["state"], ts, 0)
    assert back["tag"] == "x" and back["trace"][1][1] is None and float(back["trace"][1][0]) == 1.5
    load_pytree(path, like=back, device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, like=dict(params=tp), device="cpu")


def test_bayesopt_loop_improves():
    # tests/bayesopt/test_bayesopt.py:93
    out = tloop.run_bayesopt(function="Ackley", dim=2, acqf="ucb", num_steps=8, num_init=8, grid_size=8,
                             fit_iters=20, seed=0, verbose=False, device="cpu")
    assert out["best_per_step"][-1] >= out["best_per_step"][0]
    assert len(out["records"]) == 8


def test_bayesopt_qbatch_improves():
    # tests/bayesopt/test_bayesopt.py:154
    out = tloop.run_bayesopt(function="Ackley", dim=2, acqf="ucb", num_steps=5, num_init=8, batch_size=4,
                             grid_size=8, fit_iters=20, seed=1, verbose=False, device="cpu")
    assert out["best_per_step"][-1] >= out["best_per_step"][0]


def test_bayesopt_resume_continues_campaign(tmp_path):
    # tests/bayesopt/test_bayesopt.py:164
    ckpt = str(tmp_path / "campaign")
    kw = dict(function="Ackley", dim=2, acqf="ucb", num_steps=3, num_init=8, grid_size=8, fit_iters=10, seed=0,
              verbose=False, device="cpu")
    first = tloop.run_bayesopt(checkpoint_path=ckpt, **kw)
    second = tloop.run_bayesopt(resume_from=ckpt, **kw)
    assert second["best_per_step"][: len(first["best_per_step"])] == first["best_per_step"]
    assert len(second["best_per_step"]) == len(first["best_per_step"]) + 3
    bps = second["best_per_step"]
    assert all(b2 >= b1 - 1e-9 for b1, b2 in zip(bps, bps[1:]))
    with pytest.raises(ValueError, match="dim"):
        tloop.run_bayesopt(function="Ackley", dim=3, acqf="ucb", num_steps=1, num_init=4, grid_size=8, fit_iters=5,
                           seed=0, verbose=False, resume_from=ckpt, device="cpu")


def test_lbfgs_fit_beats_adam_at_same_budget():
    # tests/bayesopt/test_bayesopt.py:239, on its wiski_posterior fixture
    key = jax.random.PRNGKey(0)
    x = np.asarray(jax.random.uniform(key, (40, 2), minval=-1, maxval=1))
    y = np.sin(3 * x[:, :1])
    grid = JGrid.create([(-1.1, 1.1)] * 2, 10)
    tg = convert.grid_from_numpy(grid.sizes, np.asarray(grid.mins), np.asarray(grid.spacings), device="cpu")
    model = tw.WiskiModel(RBFKernel(), tg, num_outputs=1)
    params = model.init_params(2, lengthscale=0.5)
    state = tw.wiski_init(model, torch.tensor(x), torch.tensor(y), torch.full((40, 1), 0.1, dtype=torch.float64))
    cfg, losses = SolverConfig(), {}
    for method in ("adam", "lbfgs"):
        init, fit = tloop.make_fit_fn(model, cfg, method, fit_iters=20, fit_lr=0.05)
        p, _, _ = fit(params, state, init(params))
        losses[method] = float(-torch.sum(tw.wiski_mll(model, p, state, cfg)))
        assert np.isfinite(losses[method]), method
    assert losses["lbfgs"] <= losses["adam"] + 1e-6


def test_bayesopt_lbfgs_loop_and_checkpoint(tmp_path):
    # tests/bayesopt/test_bayesopt.py:260
    ckpt = str(tmp_path / "bo_final")
    out = tloop.run_bayesopt(function="Ackley", dim=2, acqf="ucb", num_steps=4, num_init=8, grid_size=8,
                             fit_iters=15, seed=0, verbose=False, fit_method="lbfgs", checkpoint_path=ckpt,
                             device="cpu")
    assert out["best_per_step"][-1] >= out["best_per_step"][0]
    blob = load_pytree(ckpt, device="cpu")
    assert set(blob) >= {"params", "state", "train_u", "train_y", "surrogate"}
    model, _ = tloop._make_surrogate(str(blob["surrogate"]), 2, 8, 0.1, device="cpu")
    mean, var = tw.wiski_predict(model, blob["params"], blob["state"], blob["train_u"])
    assert bool(torch.isfinite(mean).all() & torch.isfinite(var).all())


def test_qnipv_wiski_reduces_variance():
    # tests/bayesopt/test_active_learning.py::test_qnipv_wiski_reduces_variance
    out = run_active_learning(model_type="wiski", num_steps=5, num_init=40, num_test=200, grid_size=12, fit_iters=30,
                              verbose=False, device="cpu")
    recs = out["records"]
    assert len(recs) == 5
    assert all(np.isfinite(r["test_rmse"]) for r in recs)
    assert recs[-1]["avg_variance"] < recs[0]["avg_variance"]


def test_qnipv_exact_arm_runs():
    # tests/bayesopt/test_active_learning.py::test_qnipv_exact_arm_runs
    out = run_active_learning(model_type="exact", num_steps=3, num_init=40, num_test=200, fit_iters=30,
                              verbose=False, device="cpu")
    assert np.isfinite(out["records"][-1]["test_rmse"])


def test_mpv_osvgp_runs_and_contracts_variance():
    # tests/bayesopt/test_active_learning.py::test_mpv_osvgp_runs_and_contracts_variance
    out = run_mpv_osvgp(num_steps=4, num_init=40, num_test=200, num_inducing=24, fit_iters=80, refit_iters=8,
                        verbose=False, device="cpu")
    recs = out["records"]
    assert len(recs) == 4
    assert all(np.isfinite(r["test_rmse"]) for r in recs)
    assert recs[-1]["avg_variance"] <= recs[0]["avg_variance"] + 1e-3
