"""The port's L-BFGS (``online_gp_torch/utils/lbfgs.py``) against
``optax.lbfgs()`` at float64, iterate by iterate: on Rosenbrock for 20
iterations, three independent rows in one batch; on -sum(wiski_mll) of
the BO loop's reference surrogate (Matern-5/2, interval constraints,
Gamma priors, learned second noise) for 5 iterations; and a row outside
the active mask keeps its params and state while the others move."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from online_gp_tpu.kernels.base import make_kernel as jmake_kernel
from online_gp_tpu.kernels.priors import GammaPrior as JGamma
from online_gp_tpu.models import wiski as jw
from online_gp_tpu.ops.grid import Grid as JGrid
from online_gp_torch import convert
from online_gp_torch.kernels.base import make_kernel
from online_gp_torch.kernels.priors import GammaPrior
from online_gp_torch.models import wiski as tw
from online_gp_torch.utils.lbfgs import lbfgs_init, lbfgs_update, lbfgs_value_and_grad
from online_gp_torch.utils.optim import tree_leaves, tree_rebuild

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



def _rosen_j(p):
    return jnp.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2 + (1 - p[:-1]) ** 2)


def _rosen_vg(P):
    with torch.enable_grad():
        P = P.detach().requires_grad_(True)
        v = torch.sum(100.0 * (P[:, 1:] - P[:, :-1] ** 2) ** 2 + (1 - P[:, :-1]) ** 2, dim=-1)
        (g,) = torch.autograd.grad(v.sum(), P)
    return v.detach(), g


def _optax_runner(fn):
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(fn)

    @jax.jit
    def step(p, s):
        v, g = vg(p, state=s)
        u, s = opt.update(g, s, p, value=v, grad=g, value_fn=fn)
        return optax.apply_updates(p, u), s, v

    return opt, step


def test_rosenbrock_iterates_match_optax():
    starts = np.random.default_rng(0).uniform(-2, 2, (3, 4))
    opt, step = _optax_runner(_rosen_j)
    ps = [jnp.asarray(s) for s in starts]
    ss = [opt.init(p) for p in ps]
    P = torch.tensor(starts)
    S = lbfgs_init(P)
    for it in range(20):
        v, g = lbfgs_value_and_grad(_rosen_vg, P, S)
        u, S = lbfgs_update(g, S, P, v, _rosen_vg)
        P = P + u
        for r in range(3):
            ps[r], ss[r], jv = step(ps[r], ss[r])
            np.testing.assert_allclose(float(v[r]), float(jv), rtol=1e-8, err_msg=f"value, iteration {it}")
        want = np.stack([np.asarray(p) for p in ps])
        scale = max(1.0, np.abs(want).max())
        assert np.abs(P.numpy() - want).max() <= ITER_TOL * scale, f"iteration {it}"
    # the linesearch's cached value and gradient are optax's
    np.testing.assert_allclose(S.value.numpy(), [float(s[2].value) for s in ss], rtol=1e-8)
    assert int(S.count[0]) == 20


def test_inactive_rows_keep_their_state():
    starts = np.random.default_rng(1).uniform(-2, 2, (3, 4))
    P = torch.tensor(starts)
    S = lbfgs_init(P)
    active = torch.tensor([True, False, True])
    for _ in range(3):
        v, g = lbfgs_value_and_grad(_rosen_vg, P, S, active)
        u, S = lbfgs_update(g, S, P, v, _rosen_vg, active)
        P = P + u
    assert torch.equal(P[1], torch.tensor(starts[1]))
    assert int(S.count[1]) == 0 and torch.isinf(S.value[1]) and int(S.count[0]) == 3
    full = torch.tensor(starts[[0, 2]])
    Sf = lbfgs_init(full)
    for _ in range(3):
        v, g = lbfgs_value_and_grad(_rosen_vg, full, Sf)
        u, Sf = lbfgs_update(g, Sf, full, v, _rosen_vg)
        full = full + u
    torch.testing.assert_close(P[[0, 2]], full, rtol=0, atol=1e-12)


def _reference_surrogate(dim, grid_size):
    bounds = dict(lengthscale_bounds=(1e-4, 12.0), outputscale_bounds=(1e-4, 12.0))
    jg = JGrid.create([(-0.05, 1.05)] * dim, grid_size, dtype=jnp.float64)
    jm = jw.WiskiModel(jmake_kernel("matern52").constrain(**bounds), jg, num_outputs=1, learn_additional_noise=True,
                       priors=(("raw_lengthscale", JGamma(3.0, 6.0)), ("raw_outputscale", JGamma(2.0, 0.15))))
    tg = convert.grid_from_numpy(jg.sizes, np.asarray(jg.mins), np.asarray(jg.spacings), device="cpu")
    tm = tw.WiskiModel(make_kernel("matern52").constrain(**bounds), tg, num_outputs=1, learn_additional_noise=True,
                       priors=(("raw_lengthscale", GammaPrior(3.0, 6.0)), ("raw_outputscale", GammaPrior(2.0, 0.15))))
    return jm, tm


@pytest.mark.parametrize("dim, grid_size", [(2, 8)])
def test_wiski_mll_iterates_match_optax(dim, grid_size):
    jm, tm = _reference_surrogate(dim, grid_size)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (20, dim))
    y = (np.sin(4 * x[:, :1]) + 0.1 * rng.normal(size=(20, 1)))
    noise = np.full_like(y, 0.01)
    js = jax.jit(jw.wiski_init, static_argnums=0)(jm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise))
    ts = tw.wiski_init(tm, torch.tensor(x), torch.tensor(y), torch.tensor(noise))
    jp = jm.init_params(dim, dtype=jnp.float64)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")

    loss_j = lambda p: -jnp.sum(jw.wiski_mll(jm, p, js))
    opt, step = _optax_runner(loss_j)
    shapes = [p.shape for p in tree_leaves(tp)]
    sizes = [p.numel() for p in tree_leaves(tp)]

    def vg(X):
        with torch.enable_grad():
            ls = [c.reshape(s).requires_grad_(True) for c, s in zip(X[0].detach().split(sizes), shapes)]
            value = -torch.sum(tw.wiski_mll(tm, tree_rebuild(tp, ls), ts))
            grads = torch.autograd.grad(value, ls)
        return value.detach()[None], torch.cat([g.reshape(-1) for g in grads])[None]

    flat = torch.cat([p.reshape(-1) for p in tree_leaves(tp)])[None]
    S = lbfgs_init(flat)
    js_opt = opt.init(jp)
    for it in range(5):
        v, g = lbfgs_value_and_grad(vg, flat, S)
        u, S = lbfgs_update(g, S, flat, v, vg)
        flat = flat + u
        jp, js_opt, jv = step(jp, js_opt)
        np.testing.assert_allclose(float(v[0]), float(jv), rtol=1e-8, err_msg=f"loss, iteration {it}")
        want = np.concatenate([np.asarray(leaf).reshape(-1) for leaf in jax.tree_util.tree_leaves(jp)])
        assert np.abs(flat[0].numpy() - want).max() <= ITER_TOL * max(1.0, np.abs(want).max()), f"iteration {it}"
