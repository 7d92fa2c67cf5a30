"""The port's O-SGPR core (``online_gp_torch/models/sgpr.py``) against the
JAX package's, at float64.

Every function of the module on the same inputs in both packages (the JAX
ones jitted, the model static), with no old state and with one carried
across by ``convert``: values to rtol 1e-10, and the gradient of
``sgpr_bound`` (first round and streaming) for every leaf to 1e-8 of that
leaf's largest entry. ``sgpr_absorb`` runs both ``rebase`` branches and a
moved inducing set, chained over three rounds. ``sgpr_resample_z`` draws
from a ``torch.Generator`` where JAX takes a key, so it is held to its
properties, as the JAX package's test holds it
(tests/models/test_svgp_sgpr.py::test_resample_z_moves_points).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.kernels.base import RBFKernel as JRBF
from online_gp_tpu.models import sgpr as jsg
from online_gp_torch import convert
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models import sgpr as tsg

VAL_TOL = 1e-10
GRAD_TOL = 1e-8
M, D = 10, 2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jitted(name, **static):
    return jax.jit(functools.partial(getattr(jsg, name), **static), static_argnums=(0,))


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, tol=VAL_TOL, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * max(np.max(np.abs(want)), 1e-300), err_msg=what)


def _tree_close(want, got, tol=VAL_TOL):
    if isinstance(want, dict):
        for k in want:
            _tree_close(want[k], got[k], tol)
    elif isinstance(want, tuple):
        for a, b in zip(want, got):
            _tree_close(a, b, tol)
    else:
        _close(want, got, tol)


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    jm, tm = jsg.SGPRModel(JRBF()), tsg.SGPRModel(RBFKernel())
    z = rng.uniform(-1, 1, (M, D))
    jp = jm.init_params(jnp.asarray(z), D, dtype=jnp.float64, lengthscale=0.6)
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] + jnp.asarray([0.1, -0.15])
    jp["kernel"]["raw_outputscale"] = jp["kernel"]["raw_outputscale"] + 0.2
    jp["raw_noise"] = jnp.asarray(-1.5, jnp.float64)
    return rng, jm, tm, jp, _torch(jp)


def _torch(p):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _data(rng, n):
    x = rng.uniform(-1, 1, (n, D))
    return x, np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.1 * rng.normal(size=n)


def _old(jold):
    a = lambda v: np.asarray(v)
    return convert.sgpr_old_state_from_numpy(a(jold.z), a(jold.var_mean), jax.tree_util.tree_map(a, jold.kernel_params),
                                             a(jold.C), a(jold.c), device="cpu")


def _moved(p, shift):
    """The params after a hyper step: every leaf moved a little."""
    out = jax.tree_util.tree_map(lambda v: v + shift, p)
    return out, _torch(out)


def _first_round(rng, jm, jp):
    x, y = _data(rng, 25)
    return jax.jit(jsg.sgpr_absorb, static_argnums=(0,))(jm, jp, None, None, jnp.asarray(x), jnp.asarray(y))


def test_init_params_match_jax():
    jm, tm = jsg.SGPRModel(JRBF()), tsg.SGPRModel(RBFKernel())
    z = np.random.default_rng(1).uniform(-1, 1, (M, D))
    _tree_close(jm.init_params(jnp.asarray(z), D, dtype=jnp.float64),
                tm.init_params(torch.tensor(z), D, dtype=torch.float64, device="cpu"), 0.0)


@pytest.mark.parametrize("with_old", [False, True])
def test_information_pseudotargets_and_moments_match_jax(with_old):
    rng, jm, tm, jp, tp = _setup(2)
    jold = told = None
    if with_old:
        _, jold, _ = _first_round(rng, jm, jp)
        told = _old(jold)
        jp, tp = _moved(jp, 0.03)
        _close(_jitted("sgpr_pseudotargets")(jm, jold), tsg.sgpr_pseudotargets(tm, told))
    x, y = _data(rng, 15)
    J, T = jnp.asarray, torch.tensor
    _close(_jitted("sgpr_c_matrix")(jm, jp, jold, J(x)), tsg.sgpr_c_matrix(tm, tp, told, T(x)))
    _close(_jitted("sgpr_c_vec")(jm, jp, jold, J(x), J(y)), tsg.sgpr_c_vec(tm, tp, told, T(x), T(y)))
    jmo, tmo = _jitted("sgpr_moments")(jm, jp, jold, J(x), J(y)), tsg.sgpr_moments(tm, tp, told, T(x), T(y))
    _tree_close(jmo, tmo)
    xt = rng.uniform(-1.2, 1.2, (40, D))
    _tree_close(_jitted("sgpr_predict")(jm, jp, jmo, J(xt)), tsg.sgpr_predict(tm, tp, tmo, T(xt)))


def test_absorb_chain_matches_jax_on_both_rebase_branches_and_a_moved_z():
    """Round 1 (no old state), round 2 exact accumulation (rebase=False),
    round 3 after the hypers moved (rebase=True), round 4 onto a new
    inducing set: params, old state and moments after each."""
    rng, jm, tm, jp, tp = _setup(3)
    jf = jax.jit(jsg.sgpr_absorb, static_argnums=(0,), static_argnames=("rebase",))
    jold = jmo = told = tmo = None
    for rnd, (rebase, shift, new_z) in enumerate(
            [(True, 0.0, None), (False, 0.0, None), (True, 0.02, None), (True, 0.0, rng.uniform(-1, 1, (M + 2, D)))]):
        if shift:
            jp, tp = _moved(jp, shift)
        x, y = _data(rng, 7 + rnd)
        jz, tz = (None, None) if new_z is None else (jnp.asarray(new_z), torch.tensor(new_z))
        jp, jold, jmo = jf(jm, jp, jold, jmo, jnp.asarray(x), jnp.asarray(y), jz, rebase=rebase)
        tp, told, tmo = tsg.sgpr_absorb(tm, tp, told, tmo, torch.tensor(x), torch.tensor(y), tz, rebase=rebase)
        _tree_close(jp, tp)
        _tree_close(tuple(jold), tuple(told))
        _tree_close(tuple(jmo), tuple(tmo))


@pytest.mark.parametrize("with_old", [False, True])
def test_bound_and_its_gradient_match_jax(with_old):
    rng, jm, tm, jp, tp = _setup(4)
    jold = told = None
    if with_old:
        _, jold, _ = _first_round(rng, jm, jp)
        told = _old(jold)
        jp, tp = _moved(jp, -0.02)
    x, y = _data(rng, 12)
    J, T = jnp.asarray, torch.tensor
    jf = _jitted("sgpr_bound")
    _close(jf(jm, jp, jold, J(x), J(y)), tsg.sgpr_bound(tm, tp, told, T(x), T(y)))
    _tree_close(_jitted("sgpr_bound", combine_terms=False)(jm, jp, jold, J(x), J(y)),
                tsg.sgpr_bound(tm, tp, told, T(x), T(y), combine_terms=False))
    jg = jax.grad(lambda p: jf(jm, p, jold, J(x), J(y)))(jp)
    leaves = {"z": tp["z"], "raw_noise": tp["raw_noise"], **{f"kernel/{k}": v for k, v in tp["kernel"].items()}}
    for t in leaves.values():
        t.requires_grad_(True)
    for name, g in zip(leaves, torch.autograd.grad(tsg.sgpr_bound(tm, tp, told, T(x), T(y)), list(leaves.values()))):
        want = jg["kernel"][name[7:]] if name.startswith("kernel/") else jg[name]
        _close(want, g, GRAD_TOL, f"gradient of {name}")


def test_resample_z_moves_points():
    rng, jm, tm, jp, tp = _setup(5)
    x, _ = _data(rng, 50)
    gen = torch.Generator().manual_seed(0)
    z_new = tsg.sgpr_resample_z(tp, torch.tensor(x), 0.25, gen)
    assert z_new.shape == tp["z"].shape
    moved = torch.any(torch.abs(z_new - tp["z"]) > 1e-3, dim=-1)
    assert int(moved.sum()) == int(0.25 * M)  # the swapped rows, and only those
    assert float(torch.max(torch.abs(z_new - tp["z"])[~moved])) <= 1e-4
    for row in z_new[moved]:
        assert bool(torch.any(torch.all(torch.tensor(x) == row, dim=-1)))  # each swapped row is a new input
    again = tsg.sgpr_resample_z(tp, torch.tensor(x), 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(z_new, again)
    # a ratio that selects nothing only perturbs
    only = tsg.sgpr_resample_z(tp, torch.tensor(x), 0.0, gen)
    assert float(torch.max(torch.abs(only - tp["z"]))) <= 1e-4
