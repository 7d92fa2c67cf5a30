"""The BayesOpt adapters of the port against the JAX package's at
float64 (values to 1e-8): ``WiskiBayesOptModel.posterior`` (marginal and
joint, with and without observation noise), ``WiskiPosterior.sample``
(joint and marginal, JAX's normals handed over), ``fantasize`` (the F*B
flattening, its state and its posteriors), ``condition_on_observations``
at q = 1 and q = 2 and ``mll``; ``SVGPBayesOptModel.posterior`` (marginal
and joint)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import svgp as jsvgp
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.models import wiski_bayesopt as jbo
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import svgp as tsvgp
from online_gp_torch.models import wiski as tw
from online_gp_torch.models import wiski_bayesopt as tbo

TOL = 1e-8

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


@pytest.fixture(scope="module")
def adapters():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (30, 2))
    y = np.sin(3 * x[:, :1]) + 0.05 * rng.normal(size=(30, 1))
    noise = np.full_like(y, 0.1)
    jg = JGrid.create([(-1.1, 1.1)] * 2, 8, dtype=jnp.float64)
    jm = jw.WiskiModel(JRBF(), jg, num_outputs=1, learn_additional_noise=True)
    jp = jm.init_params(2, dtype=jnp.float64, lengthscale=0.5)
    jp["raw_second_noise"] = jp["raw_second_noise"] - 0.3
    js = jax.jit(jw.wiski_init, static_argnums=0)(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise))
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    tm = tw.WiskiModel(RBFKernel(), tg, num_outputs=1, learn_additional_noise=True)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ts = tw.wiski_init(tm, torch.tensor(x), torch.tensor(y), torch.tensor(noise))
    return jbo.WiskiBayesOptModel(jm, jp, js), tbo.WiskiBayesOptModel(tm, tp, ts), rng


def _test_points(rng, n=9):
    return rng.uniform(-0.9, 0.9, (n, 2))


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("observation_noise", [False, True])
def test_posterior(adapters, joint, observation_noise):
    ja, ta, rng = adapters
    X = _test_points(np.random.default_rng(1))
    jpost = jax.jit(lambda X: ja.posterior(X, observation_noise=observation_noise, joint=joint))(jnp.asarray(X))
    tpost = ta.posterior(torch.tensor(X), observation_noise=observation_noise, joint=joint)
    _close(tpost.mean, jpost.mean, "mean")
    _close(tpost.variance, jpost.variance, "variance")
    if joint:
        _close(tpost.cov_root, jpost.cov_root, "cov_root")
        key = jax.random.PRNGKey(5)
        eps = np.asarray(jax.random.normal(key, (4,) + jpost.cov_root.shape[:1] + jpost.cov_root.shape[-1:]))
        _close(tpost.sample(4, base_samples=torch.tensor(eps)), jax.jit(lambda p: p.sample(key, 4))(jpost),
               "joint sample")
    else:
        assert tpost.cov_root is None
        key = jax.random.PRNGKey(6)
        eps = np.asarray(jax.random.normal(key, (4,) + jpost.mean.shape))
        _close(tpost.sample(4, base_samples=torch.tensor(eps)), jax.jit(lambda p: p.sample(key, 4))(jpost),
               "marginal sample")


@pytest.mark.parametrize("q", [1, 2])
def test_fantasize(adapters, q):
    ja, ta, _ = adapters
    rng = np.random.default_rng(10 + q)
    X, Xt = rng.uniform(-0.8, 0.8, (q, 2)), _test_points(rng)
    F, key = 3, jax.random.PRNGKey(7)
    @jax.jit
    def jfant(X, Xt):
        f = ja.fantasize(X, key, num_fantasies=F)
        return f.state, f.posterior(Xt), f.posterior(Xt, joint=True), ja.posterior(Xt)

    jstate, jmarg, jjoint, jbase = jfant(jnp.asarray(X), jnp.asarray(Xt))
    k = ja.model.grid.num_points
    eps = np.asarray(jax.random.normal(key, (F, 1, k)))
    tf = ta.fantasize(torch.tensor(X), num_fantasies=F, base_samples=torch.tensor(eps))
    assert tf.num_outputs == F
    for field in ("wty", "ydy", "d_logdet"):
        _close(getattr(tf.state, field), getattr(jstate, field), field)
    for field in ("mat", "root", "inv_root"):
        _close(getattr(tf.state.roots, field), getattr(jstate.roots, field), field)
    assert tf.state.num_data == int(np.unique(np.asarray(jstate.num_data))[0])
    for joint, jpost in ((False, jmarg), (True, jjoint)):
        tpost = tf.posterior(torch.tensor(Xt), joint=joint)
        _close(tpost.mean, jpost.mean, f"fantasy mean joint={joint}")
        _close(tpost.variance, jpost.variance, f"fantasy variance joint={joint}")
    # the base adapter's state is left as it was
    _close(ta.posterior(torch.tensor(Xt)).mean, jbase.mean)


@pytest.mark.parametrize("q", [1, 2])
def test_condition_on_observations_and_mll(adapters, q):
    ja, ta, _ = adapters
    rng = np.random.default_rng(20 + q)
    X, Y, Xt = rng.uniform(-0.8, 0.8, (q, 2)), rng.normal(size=(q,)), _test_points(rng)
    @jax.jit
    def jcond(X, Y, Xt):
        jc = ja.condition_on_observations(X, Y)
        return jc.posterior(Xt), jc.mll(), ja.mll()

    jpost, jmll, jmll0 = jcond(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xt))
    tc = ta.condition_on_observations(torch.tensor(X), torch.tensor(Y))
    assert tc.state.num_data == ta.state.num_data + q
    tpost = tc.posterior(torch.tensor(Xt))
    _close(tpost.mean, jpost.mean)
    _close(tpost.variance, jpost.variance)
    _close(tc.mll(), jmll)
    _close(ta.mll(), jmll0)


@pytest.mark.parametrize("joint", [False, True])
def test_svgp_posterior(joint):
    rng = np.random.default_rng(4)
    z = rng.uniform(0, 1, (12, 2))
    jm = jsvgp.SVGPModel(JRBF())
    jp = jm.init_params(jnp.asarray(z), 2, dtype=jnp.float64, lengthscale=0.3)
    jp["var_mean"] = jnp.asarray(rng.normal(size=12))
    jp["var_chol"] = jnp.asarray(np.tril(0.1 * rng.normal(size=(12, 12))) + 0.5 * np.eye(12))
    tm = tsvgp.SVGPModel(RBFKernel())
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    X = rng.uniform(0, 1, (7, 2))
    for noise in (False, True):
        jpost = jax.jit(lambda X: jbo.SVGPBayesOptModel(jm, jp).posterior(X, observation_noise=noise,
                                                                           joint=joint))(jnp.asarray(X))
        tpost = tbo.SVGPBayesOptModel(tm, tp).posterior(torch.tensor(X), observation_noise=noise, joint=joint)
        _close(tpost.mean, jpost.mean)
        _close(tpost.variance, jpost.variance)
        if joint:
            _close(tpost.cov_root, jpost.cov_root)
        else:
            assert tpost.cov_root is None
