"""The port's grid-sharded WISKI (``SolverConfig(grid_shard_axis=...)``,
``online_gp_torch/parallel/grid.py``) against the JAX package's replicated
functions, on the CPU.

On 2 and 4 spawned gloo ranks (one spawn per world size), at the shapes of
``tests/parallel/test_mesh.py`` (a 1-D grid of 8 d points and one of 64,
24 and 32 seed points, learned second noise) and on a 2-D 8 x 8 grid, the
state row-sharded over a ``tp`` mesh:

- at float64, ``wiski_mll`` and the gradient of -sum(mll) in every param
  leaf, rtol 1e-8 (a gradient d times too large, the trap of all-reducing
  a replicated loss's cotangent, fails it); ``wiski_predict`` mean and var
  at 5 points, 1e-8; the state after a q = 1 and then a q = 3
  ``wiski_condition`` (roots, inverse roots, Gram, ``wty``, gathered over
  the ranks), 1e-8 of each tensor's scale; each rank holds m / d rows;
- at float32 (on the 8 d grid, with ``test_grid_shard_axis_constraint``'s
  inputs), JAX's tolerances of that test (which holds JAX's sharded run to
  its replicated one) against the port's replicated run at float64 on the
  same inputs: mll rtol 1e-5, mean rtol 1e-5 / atol 1e-6, var rtol 1e-4 /
  atol 1e-6 (the replicated float32 run is itself up to 3e-7 from it
  where the mean is 0; the two float32 runs part by up to 1.1e-6 there, by
  their reduction orders);
- the ValueErrors: the axis set and the state whole, m not divisible by
  the axis size, an axis the mesh lacks, a sharded state without the axis
  in the config, and ``wiski_stream`` / ``wiski_prequential_stream`` on a
  sharded state (naming the sharded streams).

In one process: ``rank1_apply_rows_plain`` on each shard's rows equals
those rows of ``rank1_apply_plain``; K_uu's rows equal those of the dense
K_uu; ``interp_root_matvec`` equals JAX's.

The spawned ranks import this module, so JAX is imported inside the tests
only.
"""

import functools

import numpy as np
import pytest
import torch

from online_gp_torch.config import SolverConfig
from online_gp_torch.parallel.launch import spawn_ranks

TOL = 1e-8
N_TEST = 5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors (the test workers
    share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(d):
    """(name, dims, points a dim, seed points, dtype) of a world of d."""
    return [("1d-8d", 1, 8 * d, 24, "float64"), ("1d-64", 1, 64, 32, "float64"), ("2d-8x8", 2, 8, 32, "float64"),
            ("1d-8d-f32", 1, 8 * d, 24, "float32")]


def _data(dims, n, dtype):
    """Seed points, targets and noise, 5 test points, and 4 points to
    condition on (q = 1, then q = 3), drawn with numpy; at float32
    ``test_grid_shard_axis_constraint``'s own (24 points on a line, sin(2x),
    unit noise)."""
    if dtype == "float32":
        x = np.linspace(-1, 1, n)[:, None]
        out = dict(x=x, y=np.sin(2 * x), noise=np.ones((n, 1)), xt=np.linspace(-0.9, 0.9, N_TEST)[:, None],
                   xc=x[:4], yc=np.sin(2 * x[:4]), nc=np.ones((4, 1)))
        return {k: v.astype(dtype) for k, v in out.items()}
    rng = np.random.default_rng(dims * 100 + n)
    x = rng.uniform(-1, 1, (n, dims))
    xc = rng.uniform(-0.95, 0.95, (4, dims))
    out = dict(x=x, y=np.sin(2 * x[:, :1]), noise=np.full((n, 1), 0.5),
               xt=np.stack([np.linspace(-0.9, 0.9, N_TEST)] * dims, axis=1),
               xc=xc, yc=np.cos(3 * xc[:, :1]), nc=np.array([[0.3], [0.4], [0.5], [0.6]]))
    return {k: v.astype(dtype) for k, v in out.items()}


def _params(dims, dtype):
    """JAX's defaults (at float32, as its test), else moved off them (the
    lengthscale, and s2 != 1)."""
    if dtype == "float32":
        return {"kernel": {"raw_lengthscale": np.full((1, dims), np.log(0.693), dtype),
                           "raw_outputscale": np.zeros((1,), dtype)},
                "raw_second_noise": np.zeros((1,), dtype)}
    return {"kernel": {"raw_lengthscale": np.full((1, dims), -0.6, dtype),
                       "raw_outputscale": np.full((1,), 0.2, dtype)},
            "raw_second_noise": np.full((1,), 0.25, dtype)}


def _port(dims, m1, dtype):
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.wiski import WiskiModel
    from online_gp_torch.ops.grid import Grid

    grid = Grid.create([(-1.1, 1.1)] * dims, m1, dtype=getattr(torch, dtype), device="cpu")
    return WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(tree).requires_grad_(grad)


def _rank(rank, world):
    """Every configuration on this rank: the MLL, its gradients, the
    moments, the conditioned states gathered, the local shapes, the
    errors."""
    from online_gp_torch.models import wiski as tw
    from online_gp_torch.parallel.grid import gather_wiski_state, shard_wiski_state
    from online_gp_torch.parallel.mesh import make_mesh
    from online_gp_torch.utils.optim import tree_leaves

    mesh = make_mesh(axis_name="tp", device_type="cpu")
    cfg = SolverConfig(grid_shard_axis="tp")
    out = {}
    for name, dims, m1, n, dtype in _configs(world):
        model = _port(dims, m1, dtype)
        a = {k: torch.from_numpy(v) for k, v in _data(dims, n, dtype).items()}
        state = shard_wiski_state(tw.wiski_init(model, a["x"], a["y"], a["noise"]), mesh, "tp")
        params = _torch_tree(_params(dims, dtype), grad=True)
        mll = tw.wiski_mll(model, params, state, cfg)
        grads = torch.autograd.grad(-torch.sum(mll), tree_leaves(params))
        params = _torch_tree(_params(dims, dtype))
        mean, var = tw.wiski_predict(model, params, state, a["xt"], cfg)
        s1 = tw.wiski_condition(model, state, a["xc"][:1], a["yc"][:1], a["nc"][:1])
        s3 = tw.wiski_condition(model, s1, a["xc"][1:], a["yc"][1:], a["nc"][1:])
        states = [gather_wiski_state(s) for s in (s1, s3)]
        # the replicated run at float64, on the same (float32) inputs
        m64, p64, a64 = _port(dims, m1, "float64"), _torch_tree(_params(dims, dtype)), {k: v.double() for k, v in a.items()}
        p64 = {"kernel": {k: v.double() for k, v in p64["kernel"].items()}, "raw_second_noise": p64["raw_second_noise"].double()}
        whole = tw.wiski_init(m64, a64["x"], a64["y"], a64["noise"])
        replicated = [tw.wiski_mll(m64, p64, whole).numpy(), *(
            t.numpy() for t in tw.wiski_predict(m64, p64, whole, a64["xt"]))]
        out[name] = dict(replicated=replicated,
            mll=mll.detach().numpy(), grads=[g.numpy() for g in grads], mean=mean.numpy(), var=var.numpy(),
            states=[[s.wty.numpy(), s.roots.mat.numpy(), s.roots.root.numpy(), s.roots.inv_root.numpy(),
                     s.ydy.numpy(), s.d_logdet.numpy(), s.num_data] for s in states],
            local=[tuple(x.to_local().shape) for x in (s3.wty, s3.roots.mat, s3.roots.root, s3.roots.inv_root)])

    errors = []
    model = _port(1, 8 * world, "float64")
    a = {k: torch.from_numpy(v) for k, v in _data(1, 24, "float64").items()}
    whole = tw.wiski_init(model, a["x"], a["y"], a["noise"])
    sharded = shard_wiski_state(whole, mesh, "tp")
    params = _torch_tree(_params(1, "float64"))
    odd = _port(1, 8 * world + 1, "float64")
    calls = [
        lambda: shard_wiski_state(tw.wiski_init(odd, a["x"], a["y"], a["noise"]), mesh, "tp"),
        lambda: tw.wiski_mll(model, params, sharded, SolverConfig(grid_shard_axis="dp")),
        lambda: tw.wiski_prediction_caches(model, params, sharded),
        lambda: tw.wiski_stream(model, sharded, a["xc"], a["yc"], a["nc"]),
        lambda: tw.wiski_prequential_stream(model, params, sharded, (None, None), a["xc"], a["yc"], a["nc"]),
    ]
    for call in calls:
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


@functools.lru_cache(maxsize=None)
def _jax_reference(dims, m1, n, dtype="float64"):
    """JAX's replicated functions (no axis set) on the same inputs."""
    import jax
    import jax.numpy as jnp

    from online_gp_tpu.kernels.base import RBFKernel
    from online_gp_tpu.models import wiski as jw
    from online_gp_tpu.ops.grid import Grid

    grid = Grid.create([(-1.1, 1.1)] * dims, m1, dtype=getattr(jnp, dtype))
    model = jw.WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    a = {k: jnp.asarray(v) for k, v in _data(dims, n, dtype).items()}
    params = jax.tree_util.tree_map(jnp.asarray, _params(dims, dtype))
    @jax.jit
    def everything(params, a):
        state = jw.wiski_init(model, a["x"], a["y"], a["noise"])
        mll, grads = jax.value_and_grad(lambda p: -jnp.sum(jw.wiski_mll(model, p, state)))(params)
        mean, var = jw.wiski_predict(model, params, state, a["xt"])
        s1 = jw.wiski_condition(model, state, a["xc"][:1], a["yc"][:1], a["nc"][:1])
        s3 = jw.wiski_condition(model, s1, a["xc"][1:], a["yc"][1:], a["nc"][1:])
        return -mll, grads, mean, var, s1, s3

    mll, grads, mean, var, *states = everything(params, a)
    states = [[np.asarray(x) for x in (s.wty, s.roots.mat, s.roots.root, s.roots.inv_root, s.ydy, s.d_logdet)]
              + [int(s.num_data)] for s in states]
    return dict(mll=np.asarray(mll), grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
                mean=np.asarray(mean), var=np.asarray(var), states=states)


@pytest.mark.parametrize("d", [2, 4])
def test_grid_sharded_wiski_matches_jax_replicated(tmp_path, d):
    ranks = spawn_ranks(_rank, d, store=str(tmp_path / "store"))
    for name, dims, m1, n, dtype in _configs(d):
        want = _jax_reference(dims, m1, n) if dtype == "float64" else None
        m = m1**dims
        for r in ranks:
            got = r[name]
            assert got["local"] == [(1, m // d, 1), (1, m // d, m), (1, m // d, m), (1, m // d, m)]
            if dtype == "float64":
                np.testing.assert_allclose(got["mll"], want["mll"], rtol=TOL, err_msg=name)
                for g, w in zip(got["grads"], want["grads"]):
                    np.testing.assert_allclose(g, w, rtol=TOL, err_msg=name)
                np.testing.assert_allclose(got["mean"], want["mean"], rtol=TOL, atol=TOL, err_msg=name)
                np.testing.assert_allclose(got["var"], want["var"], rtol=TOL, atol=TOL, err_msg=name)
                for gs, ws in zip(got["states"], want["states"]):
                    for g, w in zip(gs[:-1], ws[:-1]):
                        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max(), err_msg=name)
                    assert gs[-1] == ws[-1]
            else:
                # JAX's float32 bars of tests/parallel/test_mesh.py::
                # test_grid_shard_axis_constraint, against the replicated run at
                # float64 on the same inputs
                mll, mean, var = got["replicated"]
                np.testing.assert_allclose(got["mll"], mll, rtol=1e-5, err_msg=name)
                np.testing.assert_allclose(got["mean"], mean, rtol=1e-5, atol=1e-6, err_msg=name)
                np.testing.assert_allclose(got["var"], var, rtol=1e-4, atol=1e-6, err_msg=name)
    errors = ranks[0]["errors"]
    assert f"grid size m={8 * d + 1} must divide by the axis size {d}" in errors[0]
    assert "grid_shard_axis='dp': the state's wty is not row-sharded on mesh axis 'dp'" in errors[1]
    assert "pass SolverConfig(grid_shard_axis='tp')" in errors[2]
    assert "parallel.sharded_stream_blocked" in errors[3]
    assert "parallel.sharded_pred_stream_blocked" in errors[4]
    assert all(r["errors"] == errors for r in ranks)


def test_axis_set_on_a_whole_state_raises():
    from online_gp_torch.models import wiski as tw

    model = _port(1, 16, "float64")
    a = {k: torch.from_numpy(v) for k, v in _data(1, 24, "float64").items()}
    state = tw.wiski_init(model, a["x"], a["y"], a["noise"])
    params = _torch_tree(_params(1, "float64"))
    cfg = SolverConfig(grid_shard_axis="tp")
    for call in (lambda: tw.wiski_mll(model, params, state, cfg),
                 lambda: tw.wiski_prediction_caches(model, params, state, cfg),
                 lambda: tw.wiski_predict(model, params, state, a["xt"], cfg)):
        with pytest.raises(ValueError, match="grid_shard_axis='tp': the state's wty is not row-sharded on mesh axis"):
            call()


@pytest.mark.parametrize("d", [1, 2, 4])
def test_rank1_apply_rows_plain_is_the_rows_of_the_whole_update(d):
    from online_gp_torch.ops.cuda_root_update import rank1_apply_plain, rank1_apply_rows_plain

    rng = np.random.default_rng(d)
    Bd, m = 2, 24
    L, B, p = (torch.from_numpy(rng.normal(size=s)) for s in ((Bd, m, m), (Bd, m, m), (Bd, m)))
    wl, wb = rank1_apply_plain(L, B, p)
    rows = m // d
    for r in range(d):
        s = slice(r * rows, (r + 1) * rows)
        gl, gb = rank1_apply_rows_plain(L[:, s], B[:, s], p)
        # equal up to float64 rounding: the row block's products may block differently
        np.testing.assert_allclose(gl, wl[:, s], rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(gb, wb[:, s], rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dims,m1", [(1, 16), (2, 6)])
def test_kuu_rows_are_the_dense_rows(dims, m1):
    from online_gp_torch.kernels.grid_kernel import grid_kuu_dense
    from online_gp_torch.parallel.grid import kuu_rows

    model = _port(dims, m1, "float64")
    params = _torch_tree(_params(dims, "float64"))
    dense = grid_kuu_dense(model.kernel, params["kernel"], model.grid)
    m = m1**dims
    for row0, rows in ((0, m // 2), (m // 2, m // 2), (m // 3, m // 4)):
        assert torch.equal(kuu_rows(model, params, row0, rows), dense[:, row0 : row0 + rows])


def test_interp_root_matvec_matches_jax():
    import jax.numpy as jnp

    from online_gp_tpu.ops.interp import interp_root_matvec as jax_irm
    from online_gp_torch.ops.interp import interp_coeffs, interp_root_matvec

    model = _port(2, 8, "float64")
    rng = np.random.default_rng(5)
    idx, w = interp_coeffs(model.grid, torch.from_numpy(rng.uniform(-1, 1, (7, 2))))
    root = rng.normal(size=(2, 64, 5))
    got = interp_root_matvec(idx, w, torch.from_numpy(root))
    want = jax_irm(jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()), jnp.asarray(root))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
