"""The port's stems (``online_gp_torch/api/stems.py``, ``nn.Module``s)
against the JAX stems at float64: outputs in eval and train mode, the
BatchNorm running statistics a train-mode pass leaves, the momentum
``set_lr(bn_mom=)`` sets, and ``make_stem``. The JAX params and BatchNorm
state are carried across by ``convert.stem_from_numpy`` (single ops, rtol
1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.api import stems as js
from online_gp_torch import convert
from online_gp_torch.api import stems as ts

TOL = 1e-12


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _pair(kind, seed=0):
    """A JAX stem with its float64 params and a nontrivial BatchNorm state,
    and the torch stem loaded from them."""
    if kind == "linear":
        jstem, tstem = js.LinearStem(3, 2), ts.LinearStem(3, 2)
    else:
        jstem = js.MLPStem(3, 2, depth=2, hidden_dims="5,4", output_scale=0.9)
        tstem = ts.MLPStem(3, 2, depth=2, hidden_dims="5,4", output_scale=0.9)
    params, bn = jstem.init(jax.random.PRNGKey(seed))
    params, bn = _f64(params), _f64(bn)
    rng = np.random.default_rng(seed)
    bn["bn"]["mean"] = rng.normal(size=2)
    bn["bn"]["var"] = rng.uniform(0.5, 2.0, size=2)
    convert.stem_from_numpy(tstem, params, bn, device="cpu")
    return jstem, tstem, params, bn


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b.detach().numpy() if torch.is_tensor(b) else b), np.asarray(a),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_stem_matches_jax_in_eval_and_train_mode(kind):
    jstem, tstem, params, bn = _pair(kind)
    x = np.random.default_rng(3).normal(size=(11, 3))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbn = jax.tree_util.tree_map(jnp.asarray, bn)

    out, same = jstem.apply(jparams, jbn, jnp.asarray(x), train=False)
    tstem.eval()
    _close(out, tstem(torch.tensor(x)))
    _close(same["bn"]["mean"], tstem.bn.running_mean)  # eval mode leaves the statistics

    out, new_bn = jstem.apply(jparams, jbn, jnp.asarray(x), train=True)
    tstem.train()
    _close(out, tstem(torch.tensor(x)))
    for key, buf in (("mean", "running_mean"), ("var", "running_var")):
        _close(new_bn["bn"][key], getattr(tstem.bn, buf))
    assert tstem.bn.running_mean.dtype == torch.float64


def test_stem_gradients_match_jax():
    jstem, tstem, params, bn = _pair("mlp", seed=1)
    x = np.random.default_rng(4).normal(size=(7, 3))

    def loss(p):
        out, _ = jstem.apply(p, jax.tree_util.tree_map(jnp.asarray, bn), jnp.asarray(x), train=False)
        return jnp.sum(jnp.sin(out))

    grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    tstem.eval()
    torch.sum(torch.sin(tstem(torch.tensor(x)))).backward()
    for name, layer in grads.items():
        _close(np.asarray(layer["w"]).T, getattr(tstem, name).weight.grad)
        _close(layer["b"], getattr(tstem, name).bias.grad)


def test_float32_weights_promote_on_float64_inputs():
    """As in JAX, float32 weights on float64 inputs compute in float64, and the
    running statistics take float64 from the first update."""
    jstem, tstem = js.LinearStem(2, 2), ts.LinearStem(2, 2)
    params, bn = jstem.init(jax.random.PRNGKey(2))
    convert.stem_from_numpy(tstem, jax.tree_util.tree_map(np.asarray, params),
                            jax.tree_util.tree_map(np.asarray, bn), device="cpu")
    assert tstem.lin.weight.dtype == torch.float32
    x = np.random.default_rng(5).normal(size=(6, 2))
    out, new_bn = jstem.apply(params, bn, jnp.asarray(x), train=True)
    tstem.train()
    got = tstem(torch.tensor(x))
    assert got.dtype == torch.float64 and tstem.bn.running_mean.dtype == torch.float64
    assert tstem.bn.momentum.dtype == torch.float32
    _close(out, got)
    _close(new_bn["bn"]["var"], tstem.bn.running_var)


def test_make_stem_and_reset():
    assert isinstance(ts.make_stem("identity", 3), ts.IdentityStem)
    assert not ts.make_stem("eye", 3).has_params
    lin = ts.make_stem("linear", 3, 2)
    assert isinstance(lin, ts.LinearStem) and (lin.input_dim, lin.output_dim) == (3, 2) and lin.has_params
    mlp = ts.make_stem("mlp", 3, 2, depth=3, hidden_dims=(8,))
    assert isinstance(mlp, ts.MLPStem) and mlp.hidden_dims == [8, 8, 8] and mlp.lin3.out_features == 2
    with pytest.raises(ValueError, match="unknown stem"):
        ts.make_stem("conv", 3)
    # the same generator seed gives the same weights, U(-1/sqrt(d_in), 1/sqrt(d_in))
    a, b = ts.LinearStem(4, 3), ts.LinearStem(4, 3)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    assert torch.equal(a.lin.weight, b.lin.weight) and torch.equal(a.lin.bias, b.lin.bias)
    assert float(a.lin.weight.detach().abs().max()) <= 0.5
    assert torch.equal(a.bn.running_var, torch.ones(3)) and float(a.bn.momentum) == pytest.approx(0.1)
