"""The port's tensor-parallel streams (``online_gp_torch/parallel/mesh.py``)
against the JAX package's ``parallel.mesh`` functions.

- ``sharded_stream_blocked`` and ``sharded_pred_stream_blocked`` at float64
  on 2 and 4 ranks (spawned gloo processes on the CPU, a FileStore each),
  at the shapes of ``tests/parallel/test_mesh.py`` (m = 16, chunks of 8,
  37 points): every rank's rows against JAX's run on a mesh of as many of
  the virtual CPU devices, and against the port's single-device plain
  streams, to rtol 1e-10 / atol 1e-12; the placements; the m % d error.
- K1's and K3's stage functions (gather over a row shard, recursion on
  the summed partials, apply on a row shard) composed over 1, 2 and 4
  shards in one process against ``blocked_chunk_plain`` and
  ``pred_chunk_stencil_plain``.

The spawned ranks import this module, so JAX is imported inside the tests
only.
"""

import numpy as np
import pytest
import torch

from online_gp_torch.ops.cuda_pred_stream import (
    pred_apply_rows,
    pred_chunk_stencil_plain,
    pred_factors,
    pred_gather_rows,
)
from online_gp_torch.ops.cuda_root_update import (
    blocked_chunk_plain,
    chunk_apply_rows,
    chunk_factors,
    chunk_gather_rows,
)
from online_gp_torch.parallel.launch import spawn_ranks

RTOL, ATOL = 1e-10, 1e-12
BLOCK = 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors (the test workers
    share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs():
    """tests/parallel/test_mesh.py's shapes, drawn with numpy: a 1-D grid of
    16, 24 seed points, 37 streamed points; the roots, the caches and the
    stencils built by the port at float64 and handed to both packages."""
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.wiski import WiskiModel, wiski_init, wiski_prediction_caches
    from online_gp_torch.ops.grid import Grid
    from online_gp_torch.ops.interp import interp_coeffs

    rng = np.random.default_rng(0)
    grid = Grid.create([(-1.1, 1.1)], 16, dtype=torch.float64, device="cpu")
    model = WiskiModel(RBFKernel(), grid, num_outputs=1)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (24, 1)))
    state = wiski_init(model, x0, torch.sin(2 * x0), torch.ones((24, 1), dtype=torch.float64))
    params = model.init_params(1, dtype=torch.float64)
    mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    xs = torch.from_numpy(rng.uniform(-1, 1, (37, 1)))
    idx, wv = interp_coeffs(grid, xs, detach=True)
    arrays = dict(L=state.roots.root[0], B=state.roots.inv_root[0], C=cov_cache[0], mu=mean_cache[0, :, 0],
                  idx=idx, wv=wv, y=torch.sin(2 * xs)[:, 0], nz=torch.ones(37, dtype=torch.float64))
    return {k: v.numpy() for k, v in arrays.items()}


def _tp_rank(rank, world, a):
    """One rank: both sharded streams on the CPU at float64; returns its rows,
    the replicated moments, the placements and the m % d error."""
    from online_gp_torch.parallel.mesh import make_mesh, sharded_pred_stream_blocked, sharded_stream_blocked

    mesh = make_mesh(axis_name="tp", device_type="cpu")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    L, B = sharded_stream_blocked(t["L"], t["B"], t["idx"], t["wv"], mesh, block=BLOCK)
    C, mu, pm, pv = sharded_pred_stream_blocked(t["C"], t["mu"], t["idx"], t["wv"], t["y"], t["nz"], mesh,
                                                block=BLOCK)
    try:
        sharded_stream_blocked(t["L"][:15, :15], t["B"][:15, :15], t["idx"], t["wv"], mesh, block=BLOCK)
        error = None
    except ValueError as e:
        error = str(e)
    return dict(L=L.to_local().numpy(), B=B.to_local().numpy(), C=C.to_local().numpy(), mu=mu.to_local().numpy(),
                pm=pm.to_local().numpy(), pv=pv.to_local().numpy(), error=error,
                placements=[str(x.placements) for x in (L, C, mu, pm)])


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_streams_match_jax_and_the_single_device_streams(tmp_path, d):
    from online_gp_tpu.ops.pred_stream import pred_stream_blocked as jax_pred_stream
    from online_gp_tpu.parallel.mesh import make_mesh as jax_mesh
    from online_gp_tpu.parallel.mesh import sharded_pred_stream_blocked as jax_pred
    from online_gp_tpu.parallel.mesh import sharded_stream_blocked as jax_stream
    from online_gp_torch.ops.pred_stream import pred_stream_blocked
    from online_gp_torch.ops.root_update import roots_stream_blocked

    a = _inputs()
    ranks = spawn_ranks(_tp_rank, d, (a,), store=str(tmp_path / "store"))
    got = {k: np.concatenate([r[k] for r in ranks]) for k in ("L", "B", "C", "mu")}
    for k in ("pm", "pv"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k])  # replicated
        got[k] = ranks[0][k]
    assert ranks[0]["placements"] == ["(Shard(dim=0),)", "(Shard(dim=0),)", "(Shard(dim=0),)", "(Replicate(),)"]
    assert all(r["L"].shape == (16 // d, 16) for r in ranks)
    assert all(f"must divide by mesh axis size {d}" in r["error"] for r in ranks)

    mesh = jax_mesh(d, axis_name="tp")
    want = dict(zip(("L", "B"), jax_stream(a["L"], a["B"], a["idx"], a["wv"], mesh, block=BLOCK)))
    want.update(zip(("C", "mu", "pm", "pv"), jax_pred(a["C"], a["mu"], a["idx"], a["wv"], a["y"], a["nz"], mesh,
                                                      block=BLOCK)))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)
    # and the single-device recursions (JAX's plain one and the port's)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    L1, B1 = roots_stream_blocked(t["L"], t["B"], t["idx"], t["wv"], block=BLOCK)
    single = dict(L=L1, B=B1, **dict(zip(("C", "mu", "pm", "pv"), pred_stream_blocked(
        t["C"], t["mu"], t["idx"], t["wv"], t["y"], t["nz"], block=BLOCK))))
    ref = jax_pred_stream(a["C"], a["mu"], a["idx"], a["wv"], a["y"], a["nz"], block=BLOCK, use_pallas=False)
    for k, v in single.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    for k, v in zip(("C", "mu", "pm", "pv"), ref):
        np.testing.assert_allclose(single[k].numpy(), np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("Bd", [1, 2])
def test_stage_functions_compose_to_the_whole_chunk(d, Bd):
    rng = np.random.default_rng(10 * d + Bd)
    m, k, P = 20, 6, 4
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape))
    L, B = t(Bd, m, m), 0.2 * t(Bd, m, m)
    idx = torch.from_numpy(rng.integers(0, m, (k, P)))
    wv, w = torch.from_numpy(rng.uniform(0, 1, (Bd, k, P))), torch.from_numpy(rng.uniform(0, 1, (k, P)))
    A = t(Bd, m, m)
    C, mu, y = A @ A.mT + torch.eye(m, dtype=torch.float64), t(Bd, m), t(Bd, k)
    nz = torch.full((Bd, k), 0.5, dtype=torch.float64)
    rows = m // d
    shards = [slice(r * rows, (r + 1) * rows) for r in range(d)]

    p0 = sum(chunk_gather_rows(B[:, s], idx, wv, s.start) for s in shards)
    factors = chunk_factors(p0)
    parts = [chunk_apply_rows(L[:, s], B[:, s], *factors) for s in shards]
    want = blocked_chunk_plain(L, B, idx, wv)
    for i in range(2):
        np.testing.assert_allclose(torch.cat([p[i] for p in parts], 1), want[i], rtol=RTOL, atol=ATOL)

    partials = [pred_gather_rows(C[:, s], mu[:, s], idx, w, s.start) for s in shards]
    c0w, mu0w = (sum(p[i] for p in partials) for i in range(2))
    Z, r, pm, pv = pred_factors(idx, w, c0w, mu0w, y, nz)
    parts = [pred_apply_rows(C[:, s], mu[:, s], Z, r, s.start) for s in shards]
    want = pred_chunk_stencil_plain(C, mu, idx, w, y, nz)
    for i in range(2):
        np.testing.assert_allclose(torch.cat([p[i] for p in parts], 1), want[i], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm, want[2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pv, want[3], rtol=RTOL, atol=ATOL)
