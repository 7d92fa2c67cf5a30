"""The Woodbury MLL's closed-form backward (``_DenseInnerCore``) and its
priors against ``jax.value_and_grad`` of the JAX ``wiski_mll``.

float64 on an 8x8 grid for B = 1 and 2, the params and the state carried
across by ``online_gp_torch.convert``: the value and the gradients with
respect to the params and to the state's ``root`` and ``wty`` (the
cotangents ``fit`` needs when it differentiates through ``wiski_init``),
with the second noise learned or not and ``skip_logdet_forward`` on or off,
to rtol 1e-8 (a single op at float64). Then Gamma and Normal priors on
``raw_lengthscale`` under an ``IntervalTransform``, as
tests/ops/test_constraints.py evaluates them, and ``gradcheck`` of the
autograd Function itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.config import SolverConfig as JSolverConfig
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.kernels.priors import GammaPrior as JGamma
from online_gp_tpu.kernels.priors import NormalPrior as JNormal
from online_gp_tpu.kernels.priors import log_prior_sum as jlog_prior_sum
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels import GammaPrior, NormalPrior, RBFKernel, log_prior_sum, make_kernel
from online_gp_torch.models import wiski as tw

TOL = 1e-8
BOUNDS = (0.05, 3.0)  # the IntervalTransform of the prior cases


def _setup(B, learn_noise, prior=None):
    """JAX and torch models, params and state (30 points); with ``prior``
    the lengthscale runs under an IntervalTransform and carries it."""
    jk, tk = JRBF(), RBFKernel()
    jpriors = tpriors = None
    if prior is not None:
        jk.constrain(lengthscale_bounds=BOUNDS)
        tk.constrain(lengthscale_bounds=BOUNDS)
        jprior, tprior = prior
        jpriors, tpriors = (("raw_lengthscale", jprior),), (("raw_lengthscale", tprior),)
    jg = JGrid.create([(-1.1, 1.1)] * 2, 8, dtype=jnp.float64)
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    jm = jw.WiskiModel(jk, jg, num_outputs=B, learn_additional_noise=learn_noise, priors=jpriors)
    tm = tw.WiskiModel(tk, tg, num_outputs=B, learn_additional_noise=learn_noise, priors=tpriors)
    jp = jm.init_params(2, dtype=jnp.float64, lengthscale=0.4)
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] + jnp.linspace(-0.2, 0.3, 2)
    jp["kernel"]["raw_outputscale"] = jp["kernel"]["raw_outputscale"] + 0.1 * jnp.arange(B)
    if learn_noise:
        jp["raw_second_noise"] = jp["raw_second_noise"] - 0.4 + 0.2 * jnp.arange(B)
    rng = np.random.default_rng(10 * B + learn_noise)
    x = rng.uniform(-1.0, 1.0, (30, 2))
    y = np.sin(2.5 * x[:, :1]) * np.linspace(1.0, 0.5, B)[None] + 0.05 * rng.normal(size=(30, B))
    noise = rng.uniform(0.2, 0.6, (30, B))
    js = jax.jit(jw.wiski_init, static_argnums=(0,))(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise))
    a = lambda v: None if v is None else np.asarray(v)
    ts = convert.state_from_numpy(a(js.wty), a(js.ydy), a(js.roots.mat), a(js.roots.root),
                                  a(js.roots.inv_root), a(js.d_logdet), a(js.num_data), device="cpu")
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp, js, ts


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jm, skip):
    cfg = JSolverConfig(skip_logdet_forward=skip)

    def loss(params, root, wty, state):
        st = state._replace(wty=wty, roots=state.roots._replace(root=root))
        return -jnp.sum(jw.wiski_mll(jm, params, st, cfg))

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))


def _torch_value_and_grad(tm, tp, ts, skip):
    leaves = [tp["kernel"]["raw_lengthscale"], tp["kernel"]["raw_outputscale"]]
    if "raw_second_noise" in tp:
        leaves.append(tp["raw_second_noise"])
    root, wty = ts.roots.root.clone(), ts.wty.clone()
    for t in leaves + [root, wty]:
        t.requires_grad_(True)
    st = ts._replace(wty=wty, roots=ts.roots._replace(root=root))
    loss = -torch.sum(tw.wiski_mll(tm, tp, st, SolverConfig(skip_logdet_forward=skip)))
    grads = torch.autograd.grad(loss, leaves + [root, wty])
    return loss, grads


def _check(jm, tm, jp, tp, js, ts, skip):
    jval, (jgp, jgroot, jgwty) = _jax_value_and_grad(jm, skip)(jp, js.roots.root, js.wty, js)
    tval, tgrads = _torch_value_and_grad(tm, tp, ts, skip)
    want = [jgp["kernel"]["raw_lengthscale"], jgp["kernel"]["raw_outputscale"]]
    if "raw_second_noise" in jgp:
        want.append(jgp["raw_second_noise"])
    want += [jgroot, jgwty]
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval), rtol=TOL, atol=TOL)
    for g, w in zip(tgrads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("learn_noise", [False, True])
@pytest.mark.parametrize("skip", [False, True])
def test_mll_value_and_grads_match_jax(B, learn_noise, skip):
    _check(*_setup(B, learn_noise), skip=skip)


@pytest.mark.parametrize("B", [1, 2])
def test_skip_logdet_forward_keeps_the_gradient(B):
    """skip_logdet_forward: log|Q| leaves the value, its gradient stays (the
    port's counterpart of tests/models/test_wiski_parity.py::
    test_skip_logdet_forward_grad_intact)."""
    _, tm, _, tp, _, ts = _setup(B, True)
    full, gfull = _torch_value_and_grad(tm, tp, ts, False)
    skipped, gskip = _torch_value_and_grad(tm, tp, ts, True)
    assert not np.allclose(full.detach().numpy(), skipped.detach().numpy())
    for a, b in zip(gfull, gskip):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("prior", ["gamma", "normal"])
def test_mll_with_priors_matches_jax(prior):
    pair = {"gamma": (JGamma(3.0, 6.0), GammaPrior(3.0, 6.0)),
            "normal": (JNormal(0.5, 0.2), NormalPrior(0.5, 0.2))}[prior]
    jm, tm, jp, tp, js, ts = _setup(2, True, prior=pair)
    _check(jm, tm, jp, tp, js, ts, skip=True)
    # the prior moves the value: the same model without it differs
    bare = tm._replace(priors=None)
    with torch.no_grad():
        assert not np.allclose(tw.wiski_mll(tm, tp, ts).numpy(), tw.wiski_mll(bare, tp, ts).numpy())


def test_log_prior_sum_uses_kernel_transforms():
    """Priors evaluate on the constrained value, not exp(raw) (the port's
    counterpart of tests/ops/test_constraints.py::
    test_log_prior_sum_uses_kernel_transforms), and match the JAX sums."""
    k = make_kernel("matern52").constrain(lengthscale_bounds=(1e-4, 12.0))
    p = k.init_params(1, lengthscale=0.5, dtype=torch.float64, device="cpu")
    priors = {"raw_lengthscale": GammaPrior(3.0, 6.0)}
    got = float(log_prior_sum(priors, p, k.transforms))
    want = float(JGamma(3.0, 6.0).log_prob(jnp.asarray(0.5, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    got_exp = float(log_prior_sum(priors, p))
    want_exp = float(jlog_prior_sum({"raw_lengthscale": JGamma(3.0, 6.0)},
                                    {"raw_lengthscale": jnp.asarray(p["raw_lengthscale"].numpy())}))
    np.testing.assert_allclose(got_exp, want_exp, rtol=1e-12)
    z = torch.tensor([0.1, 0.7, 2.0], dtype=torch.float64)
    np.testing.assert_allclose(NormalPrior(0.5, 0.2).log_prob(z).numpy(),
                               np.asarray(JNormal(0.5, 0.2).log_prob(jnp.asarray(z.numpy()))), rtol=1e-12)


@pytest.mark.parametrize("B", [1, 2])
def test_dense_inner_core_gradcheck(B):
    """gradcheck of the Function at m = 6: E = C C^T (symmetric, as K_uu is)
    keeps Q SPD; every input needs grad, so the state's cotangents and the
    second solve are checked too. Then the params-only backward (the hyper
    step's) gives the same E gradient."""
    rng = np.random.default_rng(B)
    m = 6
    C = torch.tensor(rng.normal(size=(B, m, m)) / np.sqrt(m), requires_grad=True)
    L = torch.tensor(np.tril(rng.normal(size=(B, m, m))) + 2 * np.eye(m), requires_grad=True)
    w = torch.tensor(rng.normal(size=(B, m, 1)), requires_grad=True)

    def f(C, L, w):
        return tw._DenseInnerCore.apply(C @ C.mT, L, w)

    assert torch.autograd.gradcheck(f, (C, L, w), eps=1e-6, atol=1e-7, rtol=1e-6)
    outs = f(C, L, w)
    cots = [torch.tensor(rng.normal(size=o.shape)) for o in outs]
    g_all = torch.autograd.grad(outs, (C,), cots)[0]
    outs = f(C, L.detach(), w.detach())
    g_params = torch.autograd.grad(outs, (C,), cots)[0]
    np.testing.assert_allclose(g_params.numpy(), g_all.numpy(), rtol=1e-12, atol=1e-14)
