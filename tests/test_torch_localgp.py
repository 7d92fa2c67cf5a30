"""The port's local-GP mixture (``online_gp_torch/models/localgp.py``)
against the JAX package's.

- ``localgp_init``'s random assignment bit for bit (with and without the
  overflow rebalancing), the state's every field;
- a seeded stream routed and added point by point in both packages, with
  the wrapper's spawn rule: the same expert for every point, the same
  state after each (bit for bit, but for the centers: a float32 sum over
  an expert's rows, which XLA and torch order differently, so to 1e-6);
- the weights, the joint MLL and its gradient for every leaf (to 1e-8 of
  each leaf's largest entry), the mixture's predictive and log-density,
  at float64 params (values to rtol 1e-10; the state is float32 in both);
- the JAX package's own check (tests/models/test_exact_localgp.py::
  test_localgp_routing_and_mixture).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import localgp as jl
from online_gp_torch import convert
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import localgp as tl

VAL_TOL = 1e-10
GRAD_TOL = 1e-8
F32_SUM_TOL = 1e-6  # an added point's center: a float32 sum over the expert's rows, in XLA's order or torch's


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


def _close(want, got, tol=VAL_TOL, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * max(np.max(np.abs(want)), 1e-300), err_msg=what)


def _state_equal(js, ts, centers_rtol=0.0):
    for name in js._fields:
        a, b = np.asarray(getattr(js, name)), _np(getattr(ts, name))
        assert a.dtype == b.dtype, name
        if name == "centers" and centers_rtol:
            np.testing.assert_allclose(b, a, rtol=centers_rtol, atol=centers_rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jitted(name):
    return jax.jit(getattr(jl, name), static_argnums=(0,))


def _models(cap, E, lengthscale=0.4):
    jm, tm = jl.LocalGPModel(JRBF(), cap, E), tl.LocalGPModel(RBFKernel(), cap, E)
    jp = jm.init_params(2, dtype=jnp.float64, lengthscale=lengthscale)
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] + jnp.asarray([0.1, -0.2])
    jp["raw_noise"] = jnp.asarray(-2.5, jnp.float64)  # not weakly typed, as init_params makes it
    return jm, tm, jp, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _target(x):
    return np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])


@pytest.mark.parametrize("n,cap,E,seed", [(20, 32, 4, 0), (100, 32, 6, 1), (128, 32, 4, 2)])
def test_init_assignment_is_bitwise_the_jax_one(n, cap, E, seed):
    """One expert; a random split; a random split that overflows and is
    rebalanced (128 points into exactly 4 x 32)."""
    x = np.random.default_rng(seed).uniform(-1, 1, (n, 2)).astype(np.float32)
    y = _target(x).astype(np.float32)[:, None]
    jm, tm, _, _ = _models(cap, E)
    _state_equal(jl.localgp_init(jm, x, y, seed), tl.localgp_init(tm, x, y, seed, device="cpu"))
    jp, tp = jm.init_params(2, lengthscale=0.3), tm.init_params(2, device="cpu", lengthscale=0.3)
    for want, got in ((jp["raw_noise"], tp["raw_noise"]), *((jp["kernel"][k], tp["kernel"][k]) for k in jp["kernel"])):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError):
        tl.localgp_init(tm, np.zeros((cap * E + 1, 2), np.float32), np.zeros(cap * E + 1), device="cpu")


def test_stream_routing_spawning_and_mixture_match_jax():
    rng = np.random.default_rng(3)
    jm, tm, jp, tp = _models(16, 6)
    x0 = rng.uniform(-1, 1, (40, 2)).astype(np.float32)
    js, ts = jl.localgp_init(jm, x0, _target(x0)[:, None], 0), tl.localgp_init(tm, x0, _target(x0)[:, None], 0,
                                                                                device="cpu")
    xs = rng.uniform(-1, 1, (60, 2))  # float64 features, as the wrapper's at float64 inputs
    ys = _target(xs)
    experts = []
    for i in range(len(xs)):
        je = jl.localgp_route(jm, jp, js, xs[i])
        te = tl.localgp_route(tm, tp, ts, xs[i])
        assert je == te, f"point {i}: JAX routes to {je}, the port to {te}"
        if je < 0:  # the wrappers' spawn rule
            free = np.flatnonzero(np.asarray(js.active) == 0)
            je = int(free[0]) if len(free) else int(np.argsort(np.asarray(js.counts))[0])
        experts.append(je)
        js = jl.localgp_add_point(js, je, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        ts = tl.localgp_add_point(ts, je, torch.tensor(xs[i]), torch.tensor(ys[i]))
        _state_equal(js, ts, centers_rtol=F32_SUM_TOL)
    assert len(set(experts)) >= 4 and int(np.asarray(js.active).sum()) > 3  # experts were spawned

    # the functions on one state: the JAX one, carried across
    ts = convert.localgp_state_from_numpy(*(np.asarray(a) for a in js), device="cpu")
    xt = rng.uniform(-1.1, 1.1, (25, 2))
    J, T = jnp.asarray, torch.tensor
    _close(_jitted("localgp_weights")(jm, jp, js, J(xt)), tl.localgp_weights(tm, tp, ts, T(xt)))
    _close(_jitted("localgp_joint_mll")(jm, jp, js), tl.localgp_joint_mll(tm, tp, ts))
    jmean, jvar, jstats = _jitted("localgp_predict")(jm, jp, js, J(xt))
    tmean, tvar, tstats = tl.localgp_predict(tm, tp, ts, T(xt))
    for a, b in zip((jmean, jvar, *jstats), (tmean, tvar, *tstats)):
        _close(a, b)
    yt = _target(xt)
    _close(jl.localgp_log_prob(jstats, J(yt)), tl.localgp_log_prob(tstats, T(yt)))

    jg = jax.grad(lambda p: _jitted("localgp_joint_mll")(jm, p, js))(jp)
    leaves = {"raw_noise": tp["raw_noise"], **{f"kernel/{k}": v for k, v in tp["kernel"].items()}}
    for t in leaves.values():
        t.requires_grad_(True)
    for name, g in zip(leaves, torch.autograd.grad(tl.localgp_joint_mll(tm, tp, ts), list(leaves.values()))):
        want = jg["kernel"][name[7:]] if name.startswith("kernel/") else jg[name]
        _close(want, g, GRAD_TOL, f"gradient of {name}")


def test_routing_and_mixture():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (120, 1)).astype(np.float32)
    y = np.sin(3 * x[:, 0]).astype(np.float32)[:, None]
    tm = tl.LocalGPModel(RBFKernel(), max_data_per_model=64, max_experts=4)
    p = tm.init_params(1, device="cpu", lengthscale=0.3)
    p["raw_noise"] = torch.log(torch.tensor(1e-2))
    state = tl.localgp_init(tm, x, y, device="cpu")
    assert int(state.active.sum()) == 2
    for xi in rng.uniform(-1, 1, (40, 1)).astype(np.float32):
        e = tl.localgp_route(tm, p, state, xi)
        if e < 0:
            free = np.flatnonzero(_np(state.active) == 0)
            e = int(free[0]) if len(free) else int(np.argmin(_np(state.counts)))
        state = tl.localgp_add_point(state, e, torch.tensor(xi), torch.tensor(np.sin(3 * xi[0])))
    assert int(state.counts.sum()) == 160
    assert np.isfinite(float(tl.localgp_joint_mll(tm, p, state)))
    xt = torch.linspace(-0.9, 0.9, 50)[:, None]
    mean, var, stats = tl.localgp_predict(tm, p, state, xt)
    assert float(torch.sqrt(torch.mean((mean - torch.sin(3 * xt[:, 0])) ** 2))) < 0.15
    assert bool(torch.isfinite(tl.localgp_log_prob(stats, torch.sin(3 * xt[:, 0]))).all())
