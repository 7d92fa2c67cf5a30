"""``sm_partial_mll``, the stem's online objective, against the JAX
function at float64 on an 8x8 grid for B = 1 and 2: the value and the
gradients with respect to the stem's params (LinearStem and MLPStem in eval
mode, as the wrappers' stem step runs it), at q = 1 and q = 3, with the
caches built inside or passed in (rtol 1e-8, a single op at float64). The
JAX package tests no function of this directly, so the oracle is the JAX
function itself."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.api import stems as js
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.models.partial_mll import sm_partial_mll as jsm_partial_mll
from online_gp_torch import convert
from online_gp_torch.api import stems as ts
from online_gp_torch.models import wiski as tw
from online_gp_torch.models.partial_mll import sm_partial_mll

from test_torch_mll_grad import _setup

TOL = 1e-8


def _stems(kind):
    if kind == "linear":
        jstem, tstem = js.LinearStem(3, 2), ts.LinearStem(3, 2)
    else:
        jstem, tstem = js.MLPStem(3, 2, depth=1, hidden_dims=(6,)), ts.MLPStem(3, 2, depth=1, hidden_dims=(6,))
    params, bn = jstem.init(jax.random.PRNGKey(1))
    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
    params, bn = f64(params), f64(bn)
    bn["bn"]["mean"], bn["bn"]["var"] = np.array([0.1, -0.2]), np.array([0.8, 1.3])
    convert.stem_from_numpy(tstem, params, bn, device="cpu")
    tstem.eval()
    return jstem, tstem, params, bn


@functools.lru_cache(maxsize=None)
def _jax_fn(jm, jstem, with_caches):
    def loss(sp, bn, x, y, params, state, caches):
        feats, _ = jstem.apply(sp, bn, x, train=False)
        return -jnp.sum(jsm_partial_mll(jm, params, state, feats, y, caches=caches if with_caches else None))

    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kind", ["linear", "mlp"])
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("with_caches", [False, True])
def test_sm_partial_mll_and_stem_grads_match_jax(B, kind, q, with_caches):
    jm, tm, jp, tp, jst, tst = _setup(B, learn_noise=True)
    jstem, tstem, params, bn = _stems(kind)
    rng = np.random.default_rng(q + 7 * B)
    x = rng.uniform(-1.5, 1.5, (q, 3))
    y = rng.normal(size=(q, B))
    jc = tc = None
    if with_caches:
        jc = jax.jit(jw.wiski_prediction_caches, static_argnums=(0,))(jm, jp, jst)
        tc = tw.wiski_prediction_caches(tm, tp, tst)
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jval, jgrad = _jax_fn(jm, jstem, with_caches)(J(params), J(bn), jnp.asarray(x), jnp.asarray(y), jp, jst, jc)
    gp_leaves = (tp["kernel"]["raw_lengthscale"], tp["kernel"]["raw_outputscale"], tp["raw_second_noise"])
    for t in gp_leaves:
        t.requires_grad_(True)

    loss = -torch.sum(sm_partial_mll(tm, tp, tst, tstem(torch.tensor(x)), torch.tensor(y), caches=tc))
    loss.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jval), rtol=TOL, atol=TOL)
    for name, layer in jgrad.items():
        lin = getattr(tstem, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(), np.asarray(layer["w"]).T, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(layer["b"]), rtol=TOL, atol=TOL)
    # the objective reaches the stem only: the GP params get no gradient
    assert all(t.grad is None for t in gp_leaves)
