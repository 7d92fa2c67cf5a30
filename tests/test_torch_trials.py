"""The port's trial-batched and expert-parallel steps
(``online_gp_torch/parallel/mesh.py``, ``parallel/trials.py``) against the
JAX package's.

- ``batched_trials_step`` at T = 4 (float64 states and params, q = 1 on the
  K2 path's per-trial gather and q = 2 on the rank-q update) against
  ``jax.vmap`` of JAX's step: losses, params and roots to 1e-8; and against
  a loop of T single-trial steps of the port (``wiski_mll``, Adam,
  ``wiski_condition``) to 1e-10.
- ``trials_predict`` and ``trials_partial_mll`` (with its gradient to the
  features) against the single-trial functions, trial by trial.
- ``localgp_experts_step`` on 2 spawned gloo ranks, 4 experts each, against
  JAX's replicated run at the shapes of
  ``tests/parallel/test_mesh.py::test_localgp_experts_sharded_matches_replicated``
  (loss 1e-6, mixture moments 1e-5, params 1e-6), and against the port's
  one-process step.
- Both steps take an optimizer (``utils.optim``'s optax contract): with
  ``adam(LR)`` and with ``chain(zero_nans(), adam(LR))``, against JAX's
  step with ``optax.adam`` and ``optax.chain(optax.zero_nans(),
  optax.adam)``; and that chain's steps on gradients with NaN and +-Inf
  entries against optax's, update by update and state by state, at
  float64.

The spawned ranks import this module, so JAX is imported inside the tests
only.
"""

import numpy as np
import pytest
import torch

from online_gp_torch import convert
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import localgp as tl
from online_gp_torch.models.partial_mll import sm_partial_mll
from online_gp_torch.models.wiski import (
    WiskiModel,
    wiski_condition,
    wiski_init,
    wiski_mll,
    wiski_predict,
    wiski_prediction_caches,
)
from online_gp_torch.ops.grid import Grid
from online_gp_torch.parallel.launch import spawn_ranks
from online_gp_torch.parallel.mesh import batched_trials_step, localgp_experts_step
from online_gp_torch.parallel.trials import (
    stack_states,
    trials_partial_mll,
    trials_predict,
    trials_prediction_caches,
)
from online_gp_torch.utils.optim import adam, adam_init, adam_update, chain, tree_leaves, tree_rebuild, zero_nans

T = 4
N_SEED = 12
LR = 1e-2
F64 = dict(dtype=torch.float64, device="cpu")
E, CAP = 8, 8  # experts (4 a rank on 2 ranks) of 8 points each
OPTIMIZERS = ("adam", "zero_nans_adam")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors (the test workers
    share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _trial_data(q):
    """tests/parallel/test_mesh.py::test_batched_trials_sharded_step's trials,
    drawn with numpy: a 1-D grid of 10 (float32 in both packages, as JAX's
    default), N_SEED seed points a trial, then q new points."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (T, N_SEED + q, 1))
    return x[:, :N_SEED], np.sin(2 * x[:, :N_SEED]), x[:, N_SEED:], np.sin(2 * x[:, N_SEED:])


def _port_model():
    return WiskiModel(RBFKernel(), Grid.create([(-1.1, 1.1)], 10, device="cpu"), num_outputs=1, learn_additional_noise=True)


def _port_trials(q):
    model = _port_model()
    x, y, xb, yb = (torch.from_numpy(a) for a in _trial_data(q))
    states = [wiski_init(model, x[t], y[t], torch.ones_like(y[t])) for t in range(T)]
    params = {k: v for k, v in model.init_params(1, **F64).items()}
    stacked = tree_rebuild(params, [p.expand(T, *p.shape).clone() for p in tree_leaves(params)])
    return model, stacked, states, xb, yb


def _port_optimizer(name):
    return adam(LR) if name == "adam" else chain(zero_nans(), adam(LR))


def _optimizers(name):
    """(the port's, JAX's) optimizer of that name."""
    import optax

    jax_opt = optax.adam(LR) if name == "adam" else optax.chain(optax.zero_nans(), optax.adam(LR))
    return _port_optimizer(name), jax_opt


def _batched_trials_against_jax(q, opt_name):
    import jax
    import jax.numpy as jnp

    from online_gp_tpu.kernels.base import RBFKernel as JRBF
    from online_gp_tpu.models.wiski import WiskiModel as JModel
    from online_gp_tpu.models.wiski import wiski_init as jinit
    from online_gp_tpu.ops.grid import Grid as JGrid
    from online_gp_tpu.parallel.mesh import batched_trials_step as jstep

    x, y, xb, yb = _trial_data(q)
    jmodel = JModel(JRBF(), JGrid.create([(-1.1, 1.1)], 10), num_outputs=1, learn_additional_noise=True)
    optimizer, opt = _optimizers(opt_name)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jmodel.init_params(1))
    init = jax.jit(jinit, static_argnums=0)
    per = [init(jmodel, jnp.asarray(x[t]), jnp.asarray(y[t]), jnp.ones((N_SEED, 1))) for t in range(T)]
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    jstates = stack(per)
    jp = jax.tree.map(lambda a: jnp.stack([a] * T), jparams)
    want_p, _, want_s, want_l = jax.jit(jstep(jmodel, opt))(jp, jax.vmap(opt.init)(jp), jstates, xb, yb,
                                                            jnp.ones_like(yb))

    model, params, _, xbt, ybt = _port_trials(q)
    # JAX's params (float32 init values at float64) and states: the step is
    # compared, not the factorizations of wiski_init
    params = tree_rebuild(params, [torch.tensor(np.asarray(a)) for a in jax.tree.leaves(jp)])
    states = [convert.state_from_numpy(s.wty, s.ydy, s.roots.mat, s.roots.root, s.roots.inv_root, s.d_logdet,
                                       s.num_data, device="cpu") for s in per]
    step = batched_trials_step(model, optimizer)
    got_p, _, got_s, got_l = step(params, optimizer.init(tree_leaves(params)), stack_states(states), xbt, ybt,
                                  torch.ones_like(ybt))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-8, atol=1e-8)
    for a, b in zip(tree_leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-8)
    for a, b in ((got_s.roots.root, want_s.roots.root), (got_s.roots.inv_root, want_s.roots.inv_root),
                 (got_s.wty, want_s.wty), (got_s.ydy, want_s.ydy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-8)
    assert got_s.num_data == N_SEED + q and int(np.asarray(want_s.num_data)[0]) == N_SEED + q


@pytest.mark.parametrize("q", [1, 2])
def test_batched_trials_step_matches_jax_vmap(q):
    _batched_trials_against_jax(q, "adam")


@pytest.mark.parametrize("q", [1, 2])
def test_batched_trials_step_with_zero_nans_matches_jax_chain(q):
    _batched_trials_against_jax(q, "zero_nans_adam")


def test_zero_nans_adam_matches_the_optax_chain():
    """Two steps of chain(zero_nans(), adam(lr)) on float64 gradients with
    NaN and +-Inf entries against optax's chain: updates, the NaN flags and
    Adam's count and moments."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=(3, 2)), rng.normal(size=(4,)), np.array(0.5)]
    grads = [[rng.normal(size=np.shape(p)) for p in leaves] for _ in range(2)]
    grads[0][0][1, 0], grads[0][1][2], grads[1][1][0] = np.nan, np.inf, -np.inf
    grads[1][2] = np.array(np.nan)
    ours, theirs = _optimizers("zero_nans_adam")
    state = ours.init([torch.from_numpy(p) for p in leaves])
    jstate = theirs.init([jnp.asarray(p) for p in leaves])
    for g in grads:
        updates, state = ours.update([torch.from_numpy(x) for x in g], state)
        jupdates, jstate = theirs.update([jnp.asarray(x) for x in g], jstate)
        for a, b in zip(updates, jupdates):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)
        assert [bool(f) for f in state[0].found_nan] == [bool(f) for f in jstate[0].found_nan]
        jadam = jstate[1][0]  # optax.adam's scale_by_adam state
        assert int(state[1].count) == int(jadam.count)
        for a, b in zip(state[1].mu + state[1].nu, list(jadam.mu) + list(jadam.nu)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("q", [1, 2])
def test_batched_trials_step_is_a_loop_of_single_trial_steps(q):
    model, params, states, xb, yb = _port_trials(q)
    optimizer = adam(LR)
    step = batched_trials_step(model, optimizer)
    got_p, got_o, got_s, got_l = step(params, optimizer.init(tree_leaves(params)), stack_states(states), xb, yb,
                                      torch.ones_like(yb))
    for t in range(T):
        leaves = [p[t].detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = -torch.sum(wiski_mll(model, tree_rebuild(params, leaves), states[t]))
        grads = torch.autograd.grad(loss, leaves)
        updates, _ = adam_update(grads, adam_init(leaves), LR)
        new = wiski_condition(model, states[t], xb[t], yb[t], torch.ones_like(yb[t]))
        np.testing.assert_allclose(got_l[t].item(), loss.item(), rtol=1e-10)
        for a, p, u in zip(tree_leaves(got_p), leaves, updates):
            np.testing.assert_allclose(a[t].numpy(), (p + u).detach().numpy(), rtol=1e-10, atol=1e-12)
        for a, b in ((got_s.roots.root[t], new.roots.root), (got_s.roots.inv_root[t], new.roots.inv_root),
                     (got_s.roots.mat[t], new.roots.mat), (got_s.wty[t], new.wty), (got_s.ydy[t], new.ydy),
                     (got_s.d_logdet[t], new.d_logdet)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)
    assert int(got_o.count) == 1


def test_trials_predict_and_partial_mll_are_per_trial():
    model, params, states, _, _ = _port_trials(1)
    state = stack_states(states)
    rng = np.random.default_rng(1)
    xt = torch.from_numpy(rng.uniform(-1, 1, (T, 5, 1)))
    yt = torch.from_numpy(rng.normal(size=(T, 5, 1)))
    caches = trials_prediction_caches(model, params, state)
    mean, var = trials_predict(model, params, state, xt, caches=caches)
    x_req = xt.clone().requires_grad_(True)
    pmll = trials_partial_mll(model, params, state, x_req, yt, caches)
    (gx,) = torch.autograd.grad(pmll.sum(), x_req)
    for t in range(T):
        p_t = tree_rebuild(params, [p[t] for p in tree_leaves(params)])
        m_t, v_t = wiski_predict(model, p_t, states[t], xt[t])
        np.testing.assert_allclose(mean[t].numpy(), m_t.numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(var[t].numpy(), v_t.numpy(), rtol=1e-10, atol=1e-12)
        x_t = xt[t].clone().requires_grad_(True)
        want = sm_partial_mll(model, p_t, states[t], x_t, yt[t], caches=wiski_prediction_caches(model, p_t, states[t]))
        (g_t,) = torch.autograd.grad(want.sum(), x_t)
        np.testing.assert_allclose(pmll[t].detach().numpy(), want.detach().numpy(), rtol=1e-10)
        np.testing.assert_allclose(gx[t].numpy(), g_t.numpy(), rtol=1e-8, atol=1e-12)


def _localgp_data():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (CAP * E, 2)).astype(np.float32)
    return x, np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]), rng.uniform(-1, 1, (16, 2))


def _localgp_port(leaves):
    """The port's model, state, params (the float64 ``leaves``) and xt."""
    model = tl.LocalGPModel(RBFKernel(), max_data_per_model=CAP, max_experts=E)
    x, y, xt = _localgp_data()
    state = tl.localgp_init(model, x, y, device="cpu")
    params = tree_rebuild(model.init_params(2, dtype=torch.float64, device="cpu"), [torch.tensor(a) for a in leaves])
    return model, state, params, torch.from_numpy(xt)


def _experts_rank(rank, world, leaves):
    """The sharded step with each optimizer of ``OPTIMIZERS``."""
    from online_gp_torch.parallel.mesh import make_mesh, replicate, shard_leading

    model, state, params, xt = _localgp_port(leaves)
    mesh = make_mesh(device_type="cpu")
    state_sh = shard_leading(state, mesh)
    out = {}
    for name in OPTIMIZERS:
        optimizer = _port_optimizer(name)
        p, _, loss, mean, var = localgp_experts_step(model, optimizer)(
            replicate(params, mesh), optimizer.init(tree_leaves(params)), state_sh, replicate(xt, mesh))
        out[name] = dict(experts=int(state_sh.x.to_local().shape[0]), loss=loss.item(), mean=mean.numpy(),
                         var=var.numpy(), params=[a.numpy() for a in tree_leaves(p)])
    return out


def test_localgp_experts_step_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from online_gp_tpu.kernels.base import RBFKernel as JRBF
    from online_gp_tpu.models import localgp as jl
    from online_gp_tpu.parallel.mesh import localgp_experts_step as jstep

    x, y, xt = _localgp_data()
    jmodel = jl.LocalGPModel(JRBF(), max_data_per_model=CAP, max_experts=E)
    jstate = jl.localgp_init(jmodel, x, y)
    assert int(np.asarray(jstate.active).sum()) == E
    # JAX's float32 init values at float64, on both sides
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jmodel.init_params(2))
    leaves = [np.asarray(a) for a in jax.tree.leaves(jparams)]
    ranks = spawn_ranks(_experts_rank, 2, (leaves,), store=str(tmp_path / "store"))
    for name in OPTIMIZERS:
        optimizer, opt = _optimizers(name)
        want_p, _, want_l, want_m, want_v = jax.jit(jstep(jmodel, opt))(jparams, opt.init(jparams), jstate,
                                                                         jnp.asarray(xt))
        model, state, params, xtt = _localgp_port(leaves)
        one = localgp_experts_step(model, optimizer)(params, optimizer.init(tree_leaves(params)), state, xtt)
        _assert_experts_match([r[name] for r in ranks], (want_p, want_l, want_m, want_v), one)


def _assert_experts_match(ranks, want, one):
    import jax

    want_p, want_l, want_m, want_v = want
    for r in ranks:
        assert r["experts"] == E // 2
        np.testing.assert_allclose(r["loss"], float(want_l), rtol=1e-6)
        np.testing.assert_allclose(r["mean"], np.asarray(want_m), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["var"], np.asarray(want_v), rtol=1e-5, atol=1e-6)
        for a, b in zip(r["params"], jax.tree.leaves(want_p)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["loss"], one[2].item(), rtol=1e-10)
        np.testing.assert_allclose(r["mean"], one[3].numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(r["var"], one[4].numpy(), rtol=1e-10, atol=1e-12)
