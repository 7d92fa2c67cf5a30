"""The port's dense exact GP (``online_gp_torch/models/exact.py``) and
online exact GP on its masked buffer (``models/exact_online.py``) against
the JAX package's, at float64.

Every function on the same inputs in both packages (the JAX ones jitted,
the model static): values to rtol 1e-10, and the gradient of
``exact_gp_mll`` for every leaf to 1e-8 of that leaf's largest entry, at
two outputs, learned and fixed noise, with and without priors, at a
capacity larger than n (the masked rows must contribute nothing) and
after appends that double it. Then the JAX package's own checks
(tests/models/test_exact_localgp.py): the masked MLL equals the dense MLL
of the active rows, appends that grow the buffer give the batch buffer's
MLL, and the posterior interpolates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.kernels.priors import GammaPrior as JGamma
from online_gp_tpu.models import exact as jx
from online_gp_tpu.models import exact_online as jo
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.kernels import GammaPrior, RBFKernel
from online_gp_torch.models import exact as tx
from online_gp_torch.models import exact_online as to

VAL_TOL = 1e-10
GRAD_TOL = 1e-8


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


def _torch(p):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(module, name):
    return jax.jit(getattr({"exact": jx, "online": jo}[module], name), static_argnums=(0,))


def _data_close(jd, td):
    for name in ("x", "y", "noise", "mask"):
        _close(getattr(jd, name), getattr(td, name), 0.0, name)
    assert int(jd.count) == td.count


def test_ski_kernel_matrix_and_dense_gp_match_jax():
    rng = np.random.default_rng(0)
    jg = JGrid.create([(-1.1, 1.1)] * 2, 8, dtype=jnp.float64)
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    jp = JRBF().init_params(2, (2,), dtype=jnp.float64, lengthscale=0.4)
    tp = _torch(jp)
    x1, x2 = rng.uniform(-1, 1, (9, 2)), rng.uniform(-1, 1, (5, 2))
    J, T = jnp.asarray, torch.tensor
    jski = jax.jit(jx.ski_kernel_matrix, static_argnums=(0,))
    K = jski(JRBF(), jp, jg, J(x1))
    _close(K, tx.ski_kernel_matrix(RBFKernel(), tp, tg, T(x1)))
    Kc = jski(JRBF(), jp, jg, J(x2), J(x1))
    _close(Kc, tx.ski_kernel_matrix(RBFKernel(), tp, tg, T(x2), T(x1)))
    y, noise = rng.normal(size=(2, 9)), rng.uniform(0.1, 0.5, (2, 9))
    for jitter in (0.0, 1e-3):
        _close(jax.jit(jx.exact_mll, static_argnums=(3,))(K, J(y), J(noise), jitter), tx.exact_mll(T(_np(K)), T(y), T(noise), jitter))
    kdiag = rng.uniform(0.9, 1.1, (2, 5))
    for a, b in zip(jax.jit(jx.exact_posterior)(K, Kc, J(kdiag), J(y), J(noise)),
                    tx.exact_posterior(T(_np(K)), T(_np(Kc)), T(kdiag), T(y), T(noise))):
        _close(a, b)


def _models(B, learn_noise, priors):
    jpri = (("raw_lengthscale", JGamma(3.0, 6.0)),) if priors else None
    tpri = (("raw_lengthscale", GammaPrior(3.0, 6.0)),) if priors else None
    jm = jo.ExactGPModel(JRBF(), num_outputs=B, learn_noise=learn_noise, priors=jpri)
    tm = to.ExactGPModel(RBFKernel(), num_outputs=B, learn_noise=learn_noise, priors=tpri)
    jp = jm.init_params(2, dtype=jnp.float64)
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] + jnp.asarray([[0.1, -0.3]])
    if learn_noise:
        jp["raw_noise"] = jp["raw_noise"] + jnp.linspace(-1.0, -0.5, B)
    return jm, tm, jp, _torch(jp)


@pytest.mark.parametrize("B,learn_noise,priors", [(1, True, False), (2, True, True), (2, False, False)])
def test_online_exact_gp_matches_jax(B, learn_noise, priors):
    rng = np.random.default_rng(B + 2 * learn_noise)
    jm, tm, jp, tp = _models(B, learn_noise, priors)
    for want, got in ((jm.init_params(2), tm.init_params(2, device="cpu")),):
        assert got.keys() == want.keys()
        for a, b in [(want["kernel"][k], got["kernel"][k]) for k in want["kernel"]] + (
                [(want["raw_noise"], got["raw_noise"])] if learn_noise else []):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
    x = rng.uniform(-1, 1, (40, 2))
    y = np.sin(2 * x[:, :1]) * np.linspace(1.0, 0.4, B) + 0.05 * rng.normal(size=(40, B))
    noise = rng.uniform(0.05, 0.3, (40, B))
    J, T = jnp.asarray, torch.tensor
    jd = jo.exact_data_init(J(x[:30]), J(y[:30]), J(noise[:30]), capacity=32)  # 2 masked rows
    td = to.exact_data_init(T(x[:30]), T(y[:30]), T(noise[:30]), capacity=32)
    _data_close(jd, td)
    for start, q in ((30, 1), (31, 1), (32, 5), (37, 3)):  # the third append doubles the capacity
        sl = slice(start, start + q)
        jd = jo.exact_data_append(jd, J(x[sl]), J(y[sl]), J(noise[sl]))
        td = to.exact_data_append(td, T(x[sl]), T(y[sl]), T(noise[sl]))
        _data_close(jd, td)
        _close(_jitted("online", "exact_gp_mll")(jm, jp, jd), to.exact_gp_mll(tm, tp, td))
    assert td.x.shape[0] == 64 and td.count == 40
    xt = rng.uniform(-1.2, 1.2, (17, 2))
    jmean, jvar = _jitted("online", "exact_gp_posterior")(jm, jp, jd, J(xt))
    tmean, tvar = to.exact_gp_posterior(tm, tp, td, T(xt))
    _close(jmean, tmean)
    _close(jvar, tvar)
    _close(jo.exact_gp_observation_variance(jm, jp, jvar, 2.0), to.exact_gp_observation_variance(tm, tp, tvar, 2.0))

    jg = jax.grad(lambda p: jnp.sum(_jitted("online", "exact_gp_mll")(jm, p, jd)))(jp)
    leaves = {f"kernel/{k}": v for k, v in tp["kernel"].items()}
    if learn_noise:
        leaves["raw_noise"] = tp["raw_noise"]
    for t in leaves.values():
        t.requires_grad_(True)
    grads = torch.autograd.grad(torch.sum(to.exact_gp_mll(tm, tp, td)), list(leaves.values()))
    for name, g in zip(leaves, grads):
        want = jg["kernel"][name[7:]] if name.startswith("kernel/") else jg[name]
        _close(want, g, GRAD_TOL, f"gradient of {name}")


def test_masked_mll_matches_dense():
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((13, 2), generator=gen, dtype=torch.float64) * 2 - 1
    y = torch.sin(2 * x[:, :1])
    tm = to.ExactGPModel(RBFKernel(), num_outputs=1, learn_noise=True, jitter=0.0)
    p = tm.init_params(2, dtype=torch.float64, device="cpu")
    got = to.exact_gp_mll(tm, p, to.exact_data_init(x, y, capacity=32))  # 19 masked rows
    kb = {k: v[0] for k, v in p["kernel"].items()}
    want = tx.exact_mll(tm.kernel.matrix(kb, x, x), y[:, 0], torch.exp(p["raw_noise"])[0] * torch.ones(13))
    np.testing.assert_allclose(float(got[0]), float(want), rtol=1e-10)


def test_append_grows_and_matches_the_batch_buffer():
    x = torch.linspace(-1, 1, 10, dtype=torch.float64)[:, None]
    y = torch.sin(x)
    tm = to.ExactGPModel(RBFKernel(), jitter=0.0)
    p = tm.init_params(1, dtype=torch.float64, device="cpu")
    d_all = to.exact_data_init(x, y, capacity=16)
    d_inc = to.exact_data_init(x[:6], y[:6], capacity=8)
    for t in range(6, 10):
        d_inc = to.exact_data_append(d_inc, x[t : t + 1], y[t : t + 1])
    assert d_inc.count == 10 and d_inc.x.shape[0] == 16
    np.testing.assert_allclose(float(to.exact_gp_mll(tm, p, d_inc)[0]), float(to.exact_gp_mll(tm, p, d_all)[0]),
                               rtol=1e-10)


def test_exact_posterior_interpolates():
    x = torch.linspace(-1, 1, 25, dtype=torch.float64)[:, None]
    y = torch.sin(3 * x)
    tm = to.ExactGPModel(RBFKernel())
    p = tm.init_params(1, dtype=torch.float64, device="cpu", lengthscale=0.3)
    p["raw_noise"] = torch.log(torch.tensor([1e-4], dtype=torch.float64))
    mean, _ = to.exact_gp_posterior(tm, p, to.exact_data_init(x, y), x)
    np.testing.assert_allclose(_np(mean[0]), _np(y[:, 0]), atol=1e-2)
