"""The port's grid-sharded WISKI past ``max_cholesky_size`` and with the
LOVE and sampling caches (``online_gp_torch/parallel/grid.py``) against
the JAX package's replicated functions, on the CPU, float64.

Setup of ``tests/test_torch_iterative_mll.py``: a 2-D 8 x 8 grid (m = 64),
RBF, three outputs, learned second noise, 48 points, ``max_cholesky_size=32``
(under m: the CG/SLQ MLL), CG to 1e-12 and ``max_root_decomposition_size=16``
(LOVE and the sampling root below full rank); the port's float64 state
and JAX's params are carried across. On 2 and 4 spawned gloo ranks (one spawn
per world size, every configuration in it), the state row-sharded over a
``tp`` mesh, with ``use_toeplitz`` off and on:

- ``wiski_mll`` and the gradient of its sum in every param leaf, with
  JAX's probes for ``slq_key`` (``jax_probes``), to 1e-8 relative (a
  gradient d times too large fails it);
- ``fast_pred_var`` caches (gathered) and ``wiski_predict`` on them;
  ``fast_pred_samples`` predictions; ``wiski_predict_root`` (compared as
  root @ root^T) below full rank, with JAX's Lanczos start vector patched
  into ``models.wiski.root_start_vector`` inside each rank, and at full
  rank (``max_root_decomposition_size=64``, the Cholesky factor of the
  gathered cache): to 1e-8 of each output's largest magnitude;
- ``wiski_grid_root``, gathered, against the port's single-process root;
- the gradients to the points through the interpolation weights (the
  LOVE moments, the sampling root's moments, the state conditioned with
  ``detach_interp=False`` at q = 1 and q = 3) against ``jax.grad``, on
  every rank;
- the replicated outputs bitwise equal on every rank; each rank holds m / d
  rows of the caches and the grid root;
- the iterative MLL, its forward and its backward, makes no tensor with
  two dims of size m on a rank (a dispatch mode records every op's
  output shape): it gathers vectors only, and the dense path builds
  ``kuu_rows``, never the whole K_uu.

The spawned ranks import this module, so JAX is imported inside the
helpers that the test process runs only.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from online_gp_torch.config import SolverConfig
from online_gp_torch.parallel.launch import spawn_ranks

TOL = 1e-8
B, SIDE, N, N_TEST, RANK = 3, 8, 48, 10, 16
M = SIDE * SIDE
ITER = dict(max_cholesky_size=32, max_cg_iterations=256, cg_tolerance=1e-12, max_root_decomposition_size=RANK)
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors (the test workers
    share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(use_toeplitz, **kw):
    return SolverConfig(**ITER, use_toeplitz=use_toeplitz, **kw)


def _inputs():
    """The seed points, drawn with numpy, and the port's float64 state of
    them (which JAX takes too: the functions are compared, not the
    factorizations of ``wiski_init``)."""
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models import wiski as tw
    from online_gp_torch.ops.grid import Grid

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (N, 2))
    y = np.sin(3 * x[:, :1]) * np.linspace(1.0, 0.5, B)[None]
    grid = Grid.create([(-1.1, 1.1)] * 2, SIDE, dtype=torch.float64, device="cpu")
    model = tw.WiskiModel(RBFKernel(), grid, num_outputs=B, learn_additional_noise=True)
    s = tw.wiski_init(model, torch.from_numpy(x), torch.from_numpy(y), torch.full((N, B), 0.1, dtype=torch.float64))
    state = [t.numpy() for t in (s.wty, s.ydy, s.roots.mat, s.roots.root, s.roots.inv_root, s.d_logdet)]
    xc = rng.uniform(-0.95, 0.95, (4, 2))
    return dict(grid=[grid.sizes, grid.mins.numpy(), grid.spacings.numpy()], state=state + [s.num_data],
                xt=rng.uniform(-1, 1, (N_TEST, 2)), xc=xc, yc=np.cos(3 * xc[:, :1]) * np.ones((1, B)),
                nc=np.linspace(0.3, 0.6, 4)[:, None] * np.ones((1, B)))


def _jax():
    """The inputs with JAX's params, probes and start vector, and a function
    that computes every reference output of JAX's replicated functions, as
    numpy arrays."""
    import jax
    import jax.numpy as jnp

    from online_gp_tpu.config import SolverConfig as JConfig
    from online_gp_tpu.kernels.base import RBFKernel as JRBF
    from online_gp_tpu.models import wiski as jw
    from online_gp_tpu.ops.grid import Grid as JGrid
    from online_gp_tpu.ops.root_update import RootCache as JRootCache
    from tests.test_torch_iterative_mll import jax_probes

    inputs = _inputs()
    sizes, mins, spacings = inputs["grid"]
    jm = jw.WiskiModel(JRBF(), JGrid(tuple(sizes), jnp.asarray(mins), jnp.asarray(spacings)), num_outputs=B,
                       learn_additional_noise=True)
    jp = jm.init_params(2, dtype=jnp.float64)
    jp["kernel"]["raw_lengthscale"] = jp["kernel"]["raw_lengthscale"] - 0.1 * jnp.arange(B)[:, None]
    jp["raw_second_noise"] = jp["raw_second_noise"] + 0.2
    wty, ydy, mat, root, inv_root, d_logdet, n = inputs["state"]
    js = jw.WiskiState(jnp.asarray(wty), jnp.asarray(ydy), JRootCache(*map(jnp.asarray, (mat, root, inv_root))),
                       jnp.asarray(d_logdet), jnp.asarray(n, jnp.int32))
    xt = jnp.asarray(inputs["xt"])
    key = jax.random.PRNGKey(3)
    probes = jax_probes(key, B, M)
    a = np.asarray
    inputs.update(params=jax.tree_util.tree_map(a, jp), probes=[probes.slq.numpy(), probes.hutch.numpy()],
                  v0=a(jax.random.normal(jax.random.PRNGKey(0), (M,), jnp.float64)))

    def by_toeplitz(p, jcfg):
        val, g = jax.value_and_grad(lambda p: jnp.sum(jw.wiski_mll(jm, p, js, jcfg, slq_key=key)))(p)
        jcfg_v = jcfg.replace(fast_pred_var=True)
        caches = jw.wiski_prediction_caches(jm, p, js, jcfg_v)
        grads = [g["kernel"]["raw_lengthscale"], g["kernel"]["raw_outputscale"], g["raw_second_noise"]]
        return dict(mll=val, grads=grads, caches=list(caches),
                    pred_var=list(jw.wiski_predict(jm, p, js, xt, jcfg_v, caches=caches)))

    def by_rank(p, jcfg):
        mean, root = jw.wiski_predict_root(jm, p, js, xt, jcfg)
        return dict(root=[mean, root @ jnp.swapaxes(root, -1, -2)],
                    samples=list(jw.wiski_predict(jm, p, js, xt, jcfg.replace(fast_pred_samples=True))))

    def to_points(p):
        """Gradients to the points through the interpolation weights: of
        the LOVE moments, of the sampling root's moments, and of the state
        conditioned at q = 1 and q = 3 without detaching them."""
        jcfg = JConfig(**ITER)
        caches = jw.wiski_prediction_caches(jm, p, js, jcfg.replace(fast_pred_var=True))
        moments = lambda x: sum(jnp.sum(t) for t in jw.wiski_predict(jm, p, js, x, jcfg, caches=caches))
        exact = jw.wiski_prediction_caches(jm, p, js, jcfg)
        sampled = lambda x: (lambda mean, root: jnp.sum(mean) + jnp.sum(root**2))(
            *jw.wiski_predict_root(jm, p, js, x, jcfg, caches=exact))
        xc, yc, nc = (jnp.asarray(inputs[k]) for k in ("xc", "yc", "nc"))
        conditioned = lambda x, sl: _state_sum(
            jw.wiski_condition(jm, js, x, yc[sl], nc[sl], detach_interp=False), jnp.sum)
        return [jax.grad(moments)(xt), jax.grad(sampled)(xt),
                *(jax.grad(conditioned)(xc[sl], sl) for sl in (slice(0, 1), slice(1, 4)))]

    def reference():
        ref = {ut: jax.jit(by_toeplitz, static_argnums=1)(jp, JConfig(**ITER, use_toeplitz=ut)) for ut in (False, True)}
        for rank in (RANK, M):
            ref[rank] = jax.jit(by_rank, static_argnums=1)(jp, JConfig(**ITER).replace(max_root_decomposition_size=rank))
        ref = jax.tree_util.tree_map(a, ref)
        ref["to_points"] = [a(g) for g in jax.jit(to_points)(jp)]
        return ref

    return inputs, reference


def _state_sum(state, total):
    """A scalar of a state's grid tensors (of one rank's rows, sharded)."""
    return sum(total(t) for t in (state.wty, state.roots.root, state.roots.inv_root, state.roots.mat))


def _port(inputs):
    from online_gp_torch import convert
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models import wiski as tw

    grid = convert.grid_from_numpy(*inputs["grid"], device="cpu")
    model = tw.WiskiModel(RBFKernel(), grid, num_outputs=B, learn_additional_noise=True)
    state = convert.state_from_numpy(*inputs["state"], device="cpu")
    return model, state


def _params(inputs, grad=False):
    from online_gp_torch import convert

    p = convert.params_from_numpy(inputs["params"], device="cpu")
    leaves = [p["kernel"]["raw_lengthscale"], p["kernel"]["raw_outputscale"], p["raw_second_noise"]]
    for t in leaves:
        t.requires_grad_(grad)
    return p, leaves


class _Shapes(TorchDispatchMode):
    """Records the largest number of dims of size ``m`` in any op's output
    (B = 3 outputs of 32 probes fold into a batch dim of 96, not m)."""

    def __init__(self, m):
        super().__init__()
        self.m, self.most = m, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, sum(1 for s in t.shape if s == self.m))
        return out


def _rank(rank, world, inputs):
    """Every configuration on this rank, its outputs as numpy arrays."""
    from online_gp_torch.models import wiski as tw
    from online_gp_torch.parallel.grid import gather_rows, shard_wiski_state, state_layout
    from online_gp_torch.parallel.mesh import make_mesh

    tw.root_start_vector = lambda m, dtype=torch.float32, device=None: torch.tensor(
        inputs["v0"], dtype=dtype, device=device)
    mesh = make_mesh(axis_name="tp", device_type="cpu")
    model, whole = _port(inputs)
    state = shard_wiski_state(whole, mesh, "tp")
    lay = state_layout(state, "tp")
    probes = tw.MllProbes(*(torch.from_numpy(p) for p in inputs["probes"]))
    xt = torch.from_numpy(inputs["xt"])
    out = {}
    for ut in (False, True):
        cfg = _cfg(ut, grid_shard_axis="tp")
        params, leaves = _params(inputs, grad=True)
        shapes = _Shapes(M)
        with shapes:
            val = torch.sum(tw.wiski_mll(model, params, state, cfg, probes=probes))
            grads = torch.autograd.grad(val, leaves)
        params, _ = _params(inputs)
        cfg_v = cfg.replace(fast_pred_var=True)
        with torch.no_grad():
            caches = tw.wiski_prediction_caches(model, params, state, cfg_v)
            pred = tw.wiski_predict(model, params, state, xt, cfg_v, caches=caches)
        out[ut] = dict(mll=val.detach().numpy(), grads=[g.numpy() for g in grads], most=shapes.most,
                       caches=[gather_rows(c, lay).numpy() for c in caches], pred_var=[t.numpy() for t in pred],
                       local=[tuple(c.to_local().shape) for c in caches])
    params, _ = _params(inputs)
    for rank_cap in (RANK, M):
        cfg = _cfg(False, grid_shard_axis="tp").replace(max_root_decomposition_size=rank_cap)
        with torch.no_grad():
            caches = tw.wiski_prediction_caches(model, params, state, cfg)
            grid_root = tw.wiski_grid_root(model, params, state, cfg, caches)
            mean, root = tw.wiski_predict_root(model, params, state, xt, cfg, caches, grid_root)
            again = tw.wiski_predict_root(model, params, state, xt, cfg)
            samples = tw.wiski_predict(model, params, state, xt, cfg.replace(fast_pred_samples=True))
        out[rank_cap] = dict(root=[mean.numpy(), root.numpy()], again=[t.numpy() for t in again],
                             samples=[t.numpy() for t in samples], grid_root=gather_rows(grid_root, lay).numpy(),
                             local=tuple(grid_root.to_local().shape))
    out["to_points"] = _to_points(tw, model, state, params, inputs)
    return out


def _to_points(tw, model, state, params, inputs):
    """The gradients of ``to_points`` in JAX's reference on this rank: each
    rank backpropagates its own outputs (replicated moments, or its rows'
    part of the conditioned state's sum), and every rank must get the one
    process's gradient."""
    cfg = _cfg(False, grid_shard_axis="tp")
    xt, xc, yc, nc = (torch.from_numpy(inputs[k]) for k in ("xt", "xc", "yc", "nc"))
    with torch.no_grad():
        love = tw.wiski_prediction_caches(model, params, state, cfg.replace(fast_pred_var=True))
        exact = tw.wiski_prediction_caches(model, params, state, cfg)
        grid_root = tw.wiski_grid_root(model, params, state, cfg, exact)
    out = []
    for moments in (lambda x: sum(torch.sum(t) for t in tw.wiski_predict(model, params, state, x, cfg, caches=love)),
                    lambda x: (lambda mean, root: torch.sum(mean) + torch.sum(root**2))(
                        *tw.wiski_predict_root(model, params, state, x, cfg, exact, grid_root))):
        x = xt.clone().requires_grad_(True)
        out.append(torch.autograd.grad(moments(x), x)[0].numpy())
    for sl in (slice(0, 1), slice(1, 4)):
        x = xc[sl].clone().requires_grad_(True)
        conditioned = tw.wiski_condition(model, state, x, yc[sl], nc[sl], detach_interp=False)
        out.append(torch.autograd.grad(_state_sum(conditioned, lambda t: torch.sum(t.to_local())), x)[0].numpy())
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX's reference, {d: the ranks' results}): both worlds
    spawned at once, while this process compiles and runs JAX."""
    stores = tmp_path_factory.mktemp("grid_shard_iterative")
    inputs, reference = _jax()
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        spawned = {d: pool.submit(spawn_ranks, _rank, d, (inputs,), store=str(stores / f"store_{d}")) for d in WORLDS}
        ref = reference()
        return inputs, ref, {d: f.result() for d, f in spawned.items()}


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(np.max(np.abs(want)), 1e-300))


def _equal_on_every_rank(results, get):
    first = get(results[0])
    for r in results[1:]:
        for a, b in zip(first, get(r)):
            assert np.array_equal(a, b), "a replicated output differs between ranks"


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("use_toeplitz", [False, True])
def test_iterative_mll_and_gradients_match_jax(run, d, use_toeplitz):
    _, ref, ranks = run
    want = ref[use_toeplitz]
    for r in ranks[d]:
        got = r[use_toeplitz]
        _close(got["mll"], want["mll"])
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("use_toeplitz", [False, True])
def test_fast_pred_var_caches_and_predict_match_jax(run, d, use_toeplitz):
    _, ref, ranks = run
    want = ref[use_toeplitz]
    for r in ranks[d]:
        got = r[use_toeplitz]
        for g, w in zip(got["caches"] + got["pred_var"], want["caches"] + want["pred_var"]):
            _close(g, w)
        assert got["local"] == [(B, M // d, 1), (B, M // d, M)]


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("rank_cap", [RANK, M])
def test_predict_root_and_fast_pred_samples_match_jax(run, d, rank_cap):
    _, ref, ranks = run
    want = ref[rank_cap]
    for r in ranks[d]:
        got = r[rank_cap]
        mean, root = got["root"]
        assert root.shape == (B, N_TEST, rank_cap)
        _close(mean, want["root"][0])
        _close(root @ np.swapaxes(root, -1, -2), want["root"][1])
        for g, w in zip(got["samples"], want["samples"]):
            _close(g, w)
        assert all(np.array_equal(a, b) for a, b in zip(got["again"], got["root"]))
        assert got["local"] == (B, M // d, rank_cap)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("rank_cap", [RANK, M])
def test_grid_root_matches_the_single_process_root(run, d, rank_cap, monkeypatch):
    from online_gp_torch.models import wiski as tw

    inputs, _, ranks = run
    monkeypatch.setattr(tw, "root_start_vector", lambda m, dtype=torch.float32, device=None: torch.tensor(
        inputs["v0"], dtype=dtype, device=device))
    model, state = _port(inputs)
    params, _ = _params(inputs)
    with torch.no_grad():
        want = tw.wiski_grid_root(model, params, state, _cfg(False).replace(max_root_decomposition_size=rank_cap))
    for r in ranks[d]:
        _close(r[rank_cap]["grid_root"], want.numpy())


@pytest.mark.parametrize("d", WORLDS)
def test_gradients_to_the_points_match_jax(run, d):
    """Through the interpolation weights (``detach_interp_coeff`` unset,
    ``wiski_condition(detach_interp=False)``): the moments under
    ``fast_pred_var``, the sampling root's, and the state conditioned at
    q = 1 and q = 3. Each rank's part alone would be a fraction of it."""
    _, ref, ranks = run
    for r in ranks[d]:
        for g, w in zip(r["to_points"], ref["to_points"]):
            _close(g, w)


@pytest.mark.parametrize("d", WORLDS)
def test_replicated_outputs_are_bitwise_equal_on_every_rank(run, d):
    results = run[2][d]
    for ut in (False, True):
        _equal_on_every_rank(results, lambda r: [r[ut]["mll"], *r[ut]["grads"], *r[ut]["pred_var"]])
    for rank_cap in (RANK, M):
        _equal_on_every_rank(results, lambda r: [*r[rank_cap]["root"], *r[rank_cap]["samples"],
                                                 r[rank_cap]["grid_root"]])


@pytest.mark.parametrize("d", WORLDS)
def test_iterative_mll_makes_no_m_by_m_tensor(run, d):
    for r in run[2][d]:
        for ut in (False, True):
            assert r[ut]["most"] == 1, f"use_toeplitz={ut}: an op made a tensor with two dims of size m"
