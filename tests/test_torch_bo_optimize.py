"""``optimize_acqf`` of the port against the JAX package's, at float64 from
the same raw starts: ``sobol_raw_init`` equal; Adam and L-BFGS restarts on a
concave quadratic and on the analytic qUCB of a WISKI posterior (candidate
and value to 1e-6); each restart against the JAX package run on that start
alone (a vmapped restart is independent of the others), with one restart
that stops early on a plateau and keeps its best point while the others
go on; and the port versions of tests/bayesopt/test_bayesopt.py's
``test_optimize_acqf_concave`` and ``test_optimize_acqf_lbfgs_method``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.bayesopt import acquisitions as jacq
from online_gp_tpu.bayesopt import optimize as jopt
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.bayesopt import acquisitions as tacq
from online_gp_torch.bayesopt import optimize as topt
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import wiski as tw

ITER_TOL = 1e-6

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.mark.parametrize("q, d, raw, seed", [(1, 2, 24, 0), (1, 3, 32, 100003), (4, 3, 32, 7), (2, 5, 64, 12)])
def test_sobol_raw_init_matches(q, d, raw, seed):
    want = np.asarray(jopt.sobol_raw_init(q, d, raw, seed))
    got = topt.sobol_raw_init(q, d, raw, seed)
    assert got.dtype == torch.float32 and got.shape == (raw, q, d)
    np.testing.assert_array_equal(got.numpy(), want)


def _quadratic(target):
    jt, tt = jnp.asarray(target), torch.tensor(target)
    jf = lambda X: -jnp.sum((X - jt) ** 2)
    tf = lambda X: -torch.sum((X - tt) ** 2, dim=(-2, -1))
    return jf, tf


def _raw(q, d, n, seed):
    return np.asarray(jopt.sobol_raw_init(q, d, n, seed), np.float64)


def _compare(jf, tf, bounds, q, raw, method, restarts=4, maxiter=60, lr=0.1):
    jx, jv = jopt.optimize_acqf(jf, jnp.asarray(bounds), q=q, num_restarts=restarts, raw_samples=raw.shape[0],
                                maxiter=maxiter, lr=lr, method=method, raw_init=jnp.asarray(raw))
    tx, tv = topt.optimize_acqf(tf, torch.tensor(bounds), q=q, num_restarts=restarts, raw_samples=raw.shape[0],
                                maxiter=maxiter, lr=lr, method=method, raw_init=torch.tensor(raw))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ITER_TOL)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-8, atol=1e-12)
    return tx, tv


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
@pytest.mark.parametrize("q", [1, 2])
def test_concave_quadratic_matches(method, q):
    target = np.array([[0.3, -0.2], [-0.5, 0.6]])[:q]
    jf, tf = _quadratic(target)
    bounds = np.array([[-1.0, 1.0], [-1.0, 1.0]])
    tx, _ = _compare(jf, tf, bounds, q, _raw(q, 2, 16, 3), method)
    np.testing.assert_allclose(tx.numpy(), target, atol=0.05)


@pytest.fixture(scope="module")
def posterior():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (40, 2))
    y = np.sin(3 * x[:, :1])
    noise = np.full_like(y, 0.1)
    jg = JGrid.create([(-1.1, 1.1)] * 2, 10, dtype=jnp.float64)
    jm = jw.WiskiModel(JRBF(), jg, num_outputs=1)
    jp = jm.init_params(2, dtype=jnp.float64, lengthscale=0.5)
    js = jax.jit(jw.wiski_init, static_argnums=0)(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise))
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    tm = tw.WiskiModel(RBFKernel(), tg, num_outputs=1)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ts = tw.wiski_init(tm, torch.tensor(x), torch.tensor(y), torch.tensor(noise))
    return jm, jp, js, tm, tp, ts


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_analytic_qucb_matches(posterior, method):
    jm, jp, js, tm, tp, ts = posterior
    jf = jax.jit(lambda X: jacq.q_upper_confidence_bound(jm, jp, js, X, 2.0))
    ctx = tacq.acquisition_context(tm, tp, ts, root=False)
    tf = lambda X: tacq.q_upper_confidence_bound(tm, tp, ts, X, 2.0, context=ctx)
    bounds = np.array([[-1.0, 1.0], [-1.0, 1.0]])
    _compare(jf, tf, bounds, 1, _raw(1, 2, 24, 5), method, restarts=6, maxiter=40, lr=0.05)


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_each_restart_matches_and_an_early_stop_keeps_its_best(method):
    # flat (zero gradient) inside a radius-0.3 ball: a restart started there
    # stops after its first 5 iterations; the others climb toward the ball
    c = np.array([0.2, -0.1])
    jc, tc = jnp.asarray(c), torch.tensor(c)
    jf = lambda X: -jnp.sum(jax.nn.relu(jnp.sqrt(jnp.sum((X - jc) ** 2, -1)) - 0.3) ** 2)
    tf = lambda X: -torch.sum(torch.relu(torch.sqrt(torch.sum((X - tc) ** 2, -1)) - 0.3) ** 2, dim=-1)
    bounds = np.array([[-2.0, 2.0], [-2.0, 2.0]])
    starts = np.array([[[0.5 + 0.05 / 4, 0.5 - 0.02 / 4]], [[0.95, 0.9]], [[0.1, 0.15]], [[0.52, 0.47]]])
    xs, vals, iters = topt.optimize_restarts(tf, torch.tensor(bounds), torch.tensor(starts), maxiter=80, lr=0.05,
                                             method=method)
    assert int(iters[0]) == 5 and int(iters[3]) == 5 and int(iters.max()) > 5
    x0 = -2.0 + 4.0 * starts[0]
    np.testing.assert_allclose(xs[0].numpy(), x0, atol=1e-12)  # its best point never moved
    for r in range(len(starts)):
        jx, jv = jopt.optimize_acqf(jf, jnp.asarray(bounds), q=1, num_restarts=1, raw_samples=1, maxiter=80,
                                    lr=0.05, method=method, raw_init=jnp.asarray(starts[r : r + 1]))
        np.testing.assert_allclose(xs[r].numpy(), np.asarray(jx), rtol=0, atol=ITER_TOL, err_msg=f"restart {r}")
        np.testing.assert_allclose(float(vals[r]), float(jv), rtol=1e-8, atol=1e-12)


def test_optimize_acqf_concave():
    # tests/bayesopt/test_bayesopt.py::test_optimize_acqf_concave on the port
    _, tf = _quadratic(np.array([[0.3, -0.2]]))
    bounds = torch.tensor([[-1.0, 1.0], [-1.0, 1.0]])
    x, _ = topt.optimize_acqf(tf, bounds, q=1, num_restarts=4, raw_samples=16, maxiter=200, lr=0.1)
    np.testing.assert_allclose(x[0].numpy(), [0.3, -0.2], atol=0.05)


def test_optimize_acqf_lbfgs_method():
    # tests/bayesopt/test_bayesopt.py::test_optimize_acqf_lbfgs_method on the port
    _, tf = _quadratic(np.array([[0.3, -0.2]]))
    bounds = torch.tensor([[-1.0, 1.0], [-1.0, 1.0]])
    x_l, v_l = topt.optimize_acqf(tf, bounds, q=1, num_restarts=4, raw_samples=16, maxiter=60, method="lbfgs")
    np.testing.assert_allclose(x_l[0].numpy(), [0.3, -0.2], atol=0.02)
    _, v_a = topt.optimize_acqf(tf, bounds, q=1, num_restarts=4, raw_samples=16, maxiter=60, lr=0.1, method="adam")
    assert float(v_l) >= float(v_a) - 1e-6
    with pytest.raises(ValueError, match="unknown method"):
        topt.optimize_acqf(tf, bounds, q=1, method="sgd")
