"""The six acquisitions of the port against the JAX package's at float64:
values (1e-8 relative) and x-gradients (``jax.grad``; 1e-6 of the largest
entry) at q = 1 and q = 2 or 3, with JAX's normal draws handed to the
port as base samples: qEI and qUCB (the analytic q = 1 forms and the MC
q-batch forms), qNEI, qKG with ``lookahead_steps`` 0 and 5, qMVES with
the joint and the Gumbel max-value samplers, qNIPV. The posterior is the
RBF fixture of tests/bayesopt/test_bayesopt.py (m = 100, full-rank
root). test_torch_acquisitions_hoisted.py holds them below full rank, in
their batched form and with the hoisted context."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.bayesopt import acquisitions as jacq
from online_gp_tpu.config import SolverConfig as JConfig
from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.bayesopt import acquisitions as tacq
from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import wiski as tw

VAL_TOL = 1e-8
GRAD_TOL = 1e-6
S, F = 32, 3
KEY = jax.random.PRNGKey(11)
LOW_RANK = 32

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope="module")
def post():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (40, 2))
    y = np.sin(3 * x[:, :1])
    noise = np.full_like(y, 0.1)
    jg = JGrid.create([(-1.1, 1.1)] * 2, 10, dtype=jnp.float64)
    jm = jw.WiskiModel(JRBF(), jg, num_outputs=1, learn_additional_noise=True)
    jp = jm.init_params(2, dtype=jnp.float64, lengthscale=0.5)
    jp["raw_second_noise"] = jp["raw_second_noise"] + 0.2
    js = jax.jit(jw.wiski_init, static_argnums=0)(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise))
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    tm = tw.WiskiModel(RBFKernel(), tg, num_outputs=1, learn_additional_noise=True)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ts = tw.wiski_init(tm, torch.tensor(x), torch.tensor(y), torch.tensor(noise))
    extra = dict(
        disc=rng.uniform(-1, 1, (12, 2)), cand=rng.uniform(-1, 1, (24, 2)), mc=rng.uniform(-1, 1, (48, 2)),
        base=x[:16],
    )
    return jm, jp, js, tm, tp, ts, extra


def _normals(key, n, k):
    return np.asarray(jax.random.normal(key, (n, k), jnp.float64))


def _build(name, q, post, k, variant):
    """(jax fn of X, port fn of X) for one acquisition; ``k`` the root rank."""
    jm, jp, js, tm, tp, ts, ex = post
    jcfg = JConfig(max_root_decomposition_size=k)
    tcfg = SolverConfig(max_root_decomposition_size=k)
    T = torch.tensor
    if name == "ei":
        eps = _normals(KEY, S, k)
        return (lambda X: jacq.q_expected_improvement(jm, jp, js, X, jnp.asarray(0.3), KEY, S, jcfg),
                lambda X, **kw: tacq.q_expected_improvement(tm, tp, ts, X, 0.3, T(eps), S, tcfg, **kw))
    if name == "ucb":
        eps = _normals(KEY, S, k)
        return (lambda X: jacq.q_upper_confidence_bound(jm, jp, js, X, 2.0, KEY, S, jcfg),
                lambda X, **kw: tacq.q_upper_confidence_bound(tm, tp, ts, X, 2.0, T(eps), S, tcfg, **kw))
    if name == "nei":
        eps = _normals(KEY, S, k)
        return (lambda X: jacq.q_noisy_expected_improvement(jm, jp, js, X, jnp.asarray(ex["base"]), KEY, S, jcfg),
                lambda X, **kw: tacq.q_noisy_expected_improvement(tm, tp, ts, X, T(ex["base"]), T(eps), S, tcfg,
                                                                  **kw))
    if name == "kg":
        eps = _normals(KEY, F, k)
        return (lambda X: jacq.q_knowledge_gradient(jm, jp, js, X, jnp.asarray(ex["disc"]), jnp.asarray(0.5), KEY, F,
                                                    jcfg, lookahead_steps=variant),
                lambda X, **kw: tacq.q_knowledge_gradient(tm, tp, ts, X, T(ex["disc"]), 0.5, T(eps), F, tcfg,
                                                          lookahead_steps=variant, **kw))
    if name == "mves":
        k_max, k_fant = jax.random.split(KEY)
        if variant == "joint":
            max_samples = _normals(k_max, S, k)
        else:
            max_samples = np.asarray(jax.random.uniform(k_max, (S,), jnp.float64, minval=1e-4, maxval=1 - 1e-4))
        fant = _normals(k_fant, F, k)
        return (lambda X: jacq.q_max_value_entropy(jm, jp, js, X, jnp.asarray(ex["cand"]), KEY, S, jcfg, F,
                                                   noise_value=0.05, max_value_method=variant),
                lambda X, **kw: tacq.q_max_value_entropy(tm, tp, ts, X, T(ex["cand"]), T(max_samples), S, tcfg, F,
                                                         noise_value=0.05, max_value_method=variant,
                                                         fantasy_samples=T(fant), **kw))
    if name == "nipv":
        return (lambda X: jacq.q_negative_integrated_posterior_variance(jm, jp, js, X, jnp.asarray(ex["mc"]), jcfg,
                                                                        noise_value=0.1),
                lambda X, **kw: tacq.q_negative_integrated_posterior_variance(tm, tp, ts, X, T(ex["mc"]), tcfg,
                                                                              noise_value=0.1))
    raise AssertionError(name)


CASES = [
    ("ei", 1, None), ("ei", 3, None), ("ucb", 1, None), ("ucb", 2, None), ("nei", 1, None), ("nei", 2, None),
    ("kg", 1, 0), ("kg", 1, 5), ("kg", 2, 5), ("mves", 1, "joint"), ("mves", 1, "gumbel"), ("mves", 3, "joint"),
    ("mves", 2, "gumbel"), ("nipv", 1, None), ("nipv", 2, None),
]


def _points(q, seed):
    return np.random.default_rng(100 + seed).uniform(-0.8, 0.8, (q, 2))


def _check(jf, tf, X):
    jv, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(X))
    xt = torch.tensor(X, requires_grad=True)
    tv = tf(xt)
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=VAL_TOL, atol=1e-12)
    jg = np.asarray(jg)
    assert np.isfinite(jg).all()
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=GRAD_TOL * max(np.abs(jg).max(), 1e-12))
    return float(tv.detach())


@pytest.mark.parametrize("name, q, variant", CASES)
def test_value_and_gradient_match(post, name, q, variant):
    jf, tf = _build(name, q, post, 100, variant)
    _check(jf, tf, _points(q, q))


def test_mc_forms_need_draws(post):
    _, _, _, tm, tp, ts, _ = post
    X = torch.tensor(_points(2, 0))
    with pytest.raises(ValueError, match="base_samples or a generator"):
        tacq.q_upper_confidence_bound(tm, tp, ts, X, 2.0)
    g = torch.Generator().manual_seed(3)
    v1 = tacq.q_upper_confidence_bound(tm, tp, ts, X, 2.0, generator=g)
    v2 = tacq.q_upper_confidence_bound(tm, tp, ts, X, 2.0, generator=torch.Generator().manual_seed(3))
    assert float(v1) == float(v2)


def test_qei_analytic_q1_matches_mc(post):
    # tests/bayesopt/test_bayesopt.py::test_qei_analytic_q1_matches_mc on the port
    _, _, _, tm, tp, ts, _ = post
    cand = torch.tensor([[0.45, -0.2]], dtype=torch.float64)
    analytic = float(tacq.q_expected_improvement(tm, tp, ts, cand, 0.3))
    mc_dup = float(tacq.q_expected_improvement(tm, tp, ts, cand.repeat(2, 1), 0.3, num_samples=8192,
                                               generator=torch.Generator().manual_seed(4)))
    assert analytic >= 0.0
    np.testing.assert_allclose(mc_dup, analytic, rtol=0.1, atol=5e-4)
