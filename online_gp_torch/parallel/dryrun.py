"""The multi-rank dry run (the port of the JAX repo's ``dryrun_multichip``):
every parallel arm of the port on ``n_ranks`` processes, each held to its
one-process run.

    errors = dryrun_multichip(2, "cuda")   # {arm: max |ranks - one process|}

The ranks are spawned gloo processes (:func:`online_gp_torch.parallel.launch.
spawn_ranks`, sharing the card on "cuda"); the one-process runs are made in
the calling process, on the same inputs, drawn from seeded generators on
the CPU. The arms:

- ``grid_sharded``: WISKI with the grid row-sharded over ``tp``
  (``SolverConfig(grid_shard_axis="tp")``): a hyper step with Adam, a
  ``wiski_condition(detach_interp=False)`` of two points, then
  ``sharded_stream_blocked`` of the conditioned roots; against the whole
  state's ``wiski_mll``, ``wiski_condition`` and ``roots_stream_blocked``.
- ``grid_sharded_iterative``: the same axis past ``max_cholesky_size`` on
  an 8 x 8 grid (m = 64 > 32): a hyper step with Adam on the CG/SLQ MLL
  (Toeplitz K_uu products, probes from one seeded generator), then the
  ``fast_pred_var`` caches (LOVE at rank 16) and a predict; against the
  whole state's run of the same calls.
- ``lowrank_toeplitz``: rank-capped WISKI trials with Toeplitz K_uu
  products (an MLL step, a condition, a predict), the trials split over
  ``dp``.
- ``svgp_dp``: one replicated O-SVGP, the minibatch's rows split over the
  ranks; each rank's share of the ELBO + streaming-correction loss and its
  gradients are summed by all_reduce before one Adam step.
- ``localgp_experts``: :func:`~online_gp_torch.parallel.mesh.localgp_experts_step`
  with the experts split over ``dp``.
- ``sgpr_dp``: streaming O-SGPR trials (an initial absorb, then chunks with
  a bound step and a rebasing absorb every second one), split over ``dp``.
- ``fantasy_bo``: the q-fantasy lookahead: ``wiski_fantasize``, then
  ``wiski_predict`` per fantasy, the fantasies split over the ranks.

Every arm must agree with its one-process run within 1e-5 of max(1, the
largest magnitude of what is compared), JAX's bound; the call raises
AssertionError naming the arms that do not.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

BOUND = 1e-5
ARMS = ("grid_sharded", "grid_sharded_iterative", "lowrank_toeplitz", "svgp_dp", "localgp_experts", "sgpr_dp",
        "fantasy_bo")


class _World:
    """This process's place: rank and world size (1 for the one-process
    run), the device, and the number of ranks of the dry run (which sizes
    the arms alike in both runs)."""

    def __init__(self, rank: int, size: int, device: torch.device, n_ranks: int):
        self.rank, self.size, self.device, self.n_ranks = rank, size, device, n_ranks

    def span(self, n: int):
        from online_gp_torch.parallel.mesh import _chunk_bounds

        return _chunk_bounds(n, self.size, self.rank)

    def gather(self, n: int, rows: torch.Tensor) -> torch.Tensor:
        """The whole (n, ...) tensor from each rank's rows of it (one
        all_reduce of a zero-filled buffer)."""
        lo, hi = self.span(n)
        full = rows.new_zeros((n, *rows.shape[1:]))
        full[lo:hi] = rows
        if self.size > 1:
            dist.all_reduce(full)
        return full

    def sum(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.size == 1:
            return tensors
        from online_gp_torch.parallel.mesh import _all_reduce

        return _all_reduce(tensors, None)

    def mesh(self, axis: str):
        from online_gp_torch.parallel.mesh import make_mesh

        return make_mesh(axis_name=axis, device_type=self.device.type)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _uniform(shape, seed: int, device) -> torch.Tensor:
    return (torch.rand(shape, generator=_gen(seed)) * 2.0 - 1.0).to(device)


def _adam_step(loss_fn, params, lr: float = 1e-2, reduce=None):
    """(loss, params after one ``optax.adam(lr)`` step); ``reduce`` sums the
    loss and gradients over ranks first."""
    from online_gp_torch.utils.optim import adam_init, adam_update, tree_leaves, tree_rebuild

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_rebuild(params, leaves))
        grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    if reduce is not None:
        loss, *grads = reduce([loss, *grads])
    updates, _ = adam_update(grads, adam_init(leaves), lr)
    return loss, tree_rebuild(params, [p.detach() + u for p, u in zip(leaves, updates)])


def _flat(*tensors) -> np.ndarray:
    return np.concatenate([t.detach().reshape(-1).double().cpu().numpy() for t in tensors])


# ---------------------------------------------------------------------------
# the arms
# ---------------------------------------------------------------------------


def _grid_sharded(w: _World) -> Dict[str, np.ndarray]:
    from torch.distributed.tensor import DTensor, Shard

    from online_gp_torch.config import SolverConfig
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.wiski import WiskiModel, wiski_condition, wiski_init, wiski_mll
    from online_gp_torch.ops.grid import Grid
    from online_gp_torch.ops.interp import interp_coeffs
    from online_gp_torch.ops.root_update import roots_stream_blocked
    from online_gp_torch.parallel.grid import gather_wiski_state, shard_wiski_state
    from online_gp_torch.parallel.mesh import sharded_stream_blocked
    from online_gp_torch.utils.optim import tree_leaves

    dev = w.device
    grid = Grid.create([(-1.1, 1.1)], 64, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(1)
    x = torch.linspace(-1, 1, 32, device=dev)[:, None]
    y = torch.sin(2 * x)
    state = wiski_init(model, x, y, torch.ones_like(y))
    cfg = SolverConfig()
    if w.size > 1:
        mesh = w.mesh("tp")
        state, cfg = shard_wiski_state(state, mesh, "tp"), SolverConfig(grid_shard_axis="tp")
    loss, params = _adam_step(lambda p: -torch.sum(wiski_mll(model, p, state, cfg)), params)
    state = wiski_condition(model, state, x[:2], y[:2], torch.ones_like(y[:2]), detach_interp=False)
    idx, wv = interp_coeffs(grid, torch.linspace(-0.95, 0.95, 24, device=dev)[:, None], detach=True)
    if w.size > 1:
        put = lambda t: DTensor.from_local(t.to_local()[0].detach().contiguous(), mesh, [Shard(0)], run_check=False)
        L, B = sharded_stream_blocked(put(state.roots.root), put(state.roots.inv_root), idx, wv, mesh, "tp",
                                      block=8)
        L, B = (w.gather(64, t.to_local()) for t in (L, B))
        state = gather_wiski_state(state)
    else:
        L, B = roots_stream_blocked(state.roots.root[0].detach().clone(), state.roots.inv_root[0].detach().clone(),
                                    idx, wv, block=8)
    return dict(loss=_flat(loss), params=_flat(*tree_leaves(params)),
                conditioned=_flat(state.roots.root, state.roots.inv_root, state.roots.mat, state.wty),
                streamed=_flat(L, B))


def _grid_sharded_iterative(w: _World) -> Dict[str, np.ndarray]:
    from online_gp_torch.config import SolverConfig
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.wiski import WiskiModel, wiski_init, wiski_mll, wiski_predict
    from online_gp_torch.ops.grid import Grid
    from online_gp_torch.parallel.grid import shard_wiski_state
    from online_gp_torch.utils.optim import tree_leaves

    dev = w.device
    model = WiskiModel(RBFKernel(), Grid.create([(-1.1, 1.1)] * 2, 8, device=dev), num_outputs=1,
                       learn_additional_noise=True)
    x = _uniform((48, 2), 60, dev)
    y = torch.sin(3 * x[:, :1])
    state = wiski_init(model, x, y, torch.ones_like(y))
    cfg = SolverConfig(max_cholesky_size=32, use_toeplitz=True, fast_pred_var=True, max_root_decomposition_size=16)
    if w.size > 1:
        state, cfg = shard_wiski_state(state, w.mesh("tp"), "tp"), cfg.replace(grid_shard_axis="tp")
    loss, params = _adam_step(lambda p: -torch.sum(wiski_mll(model, p, state, cfg, generator=_gen(61))),
                              model.init_params(2))
    with torch.no_grad():
        mean, var = wiski_predict(model, params, state, _uniform((16, 2), 62, dev), cfg)
    return dict(loss=_flat(loss), params=_flat(*tree_leaves(params)), mean=_flat(mean), var=_flat(var))


def _lowrank_toeplitz(w: _World) -> Dict[str, np.ndarray]:
    from online_gp_torch.config import SolverConfig
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.wiski_lowrank import (
        WiskiLowRankModel,
        wiski_lowrank_condition,
        wiski_lowrank_init,
        wiski_lowrank_mll,
        wiski_lowrank_predict,
    )
    from online_gp_torch.ops.grid import Grid

    dev, T = w.device, 2 * w.n_ranks
    grid = Grid.create([(-1.1, 1.1)], 32, device=dev)
    model = WiskiLowRankModel(RBFKernel(), grid, rank=8, buffer_cols=16, learn_additional_noise=True,
                              use_toeplitz=True)
    cfg = SolverConfig(use_toeplitz=True)
    lo, hi = w.span(T)
    rows = []
    for t in range(lo, hi):
        x = _uniform((16, 1), 30 + t, dev)
        y = torch.sin(2 * x) + 0.1 * torch.randn((16, 1), generator=_gen(40 + t)).to(dev)
        state = wiski_lowrank_init(model, x, y, torch.ones_like(y))
        loss, params = _adam_step(lambda p: -wiski_lowrank_mll(model, p, state, cfg), model.init_params(1))
        xb = _uniform((2, 1), 50 + t, dev)
        state = wiski_lowrank_condition(model, state, xb, torch.sin(2 * xb), torch.ones_like(xb))
        mean, var = wiski_lowrank_predict(model, params, state, xb, cfg)
        rows.append(torch.cat([loss.reshape(1), mean.reshape(-1), var.reshape(-1)]))
    width = 5
    local = torch.stack(rows) if rows else torch.zeros((0, width), device=dev)
    return dict(trials=_flat(w.gather(T, local)))


def _svgp_dp(w: _World) -> Dict[str, np.ndarray]:
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.svgp import (
        SVGPModel,
        svgp_elbo,
        svgp_init_variational_to_prior,
        svgp_snapshot,
        svgp_streaming_correction,
    )
    from online_gp_torch.utils.optim import tree_leaves

    dev = w.device
    model = SVGPModel(RBFKernel(), likelihood="gaussian")
    params = svgp_init_variational_to_prior(model, model.init_params(_uniform((8, 1), 5, dev), 1, device=dev))
    n = 4 * w.n_ranks
    x = torch.linspace(-1, 1, n, device=dev)[:, None]
    y = torch.sin(2 * x)
    old = svgp_snapshot(model, params)
    lo, hi = w.span(n)
    share = (hi - lo) / n

    def loss_fn(p):
        # this rank's rows of the mean expected log-likelihood (the KL term
        # shared out with them) and its part of the correction
        elbo = svgp_elbo(model, p, x[lo:hi], y[lo:hi], n, 1e-3)
        return -share * elbo + svgp_streaming_correction(model, p, old, n, 1e-3) / w.size

    loss, params = _adam_step(loss_fn, params, reduce=w.sum)
    return dict(loss=_flat(loss), params=_flat(*tree_leaves(params)))


def _localgp_experts(w: _World) -> Dict[str, np.ndarray]:
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.localgp import LocalGPModel, localgp_init
    from online_gp_torch.parallel.mesh import localgp_experts_step, replicate, shard_leading
    from online_gp_torch.utils.optim import adam, tree_leaves

    dev, E = w.device, 2 * w.n_ranks
    model = LocalGPModel(RBFKernel(), max_data_per_model=8, max_experts=E)
    x = _uniform((8 * E, 2), 6, "cpu").numpy()
    state = localgp_init(model, x, np.sin(3 * x[:, 0]), device=dev)
    params = model.init_params(2, device=dev)
    xt = _uniform((8, 2), 7, dev)
    optimizer = adam(1e-2)
    opt = optimizer.init(tree_leaves(params))
    if w.size > 1:
        mesh = w.mesh("dp")
        state, params, xt = shard_leading(state, mesh), replicate(params, mesh), replicate(xt, mesh)
    params, _, loss, mean, var = localgp_experts_step(model, optimizer)(params, opt, state, xt)
    return dict(loss=_flat(loss), params=_flat(*tree_leaves(params)), mean=_flat(mean), var=_flat(var))


def _sgpr_dp(w: _World) -> Dict[str, np.ndarray]:
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.sgpr import SGPRModel, sgpr_absorb, sgpr_bound, sgpr_predict
    from online_gp_torch.utils.optim import adam_init, adam_update, tree_leaves, tree_rebuild

    dev, T = w.device, 2 * w.n_ranks
    model = SGPRModel(RBFKernel(), jitter=1e-4)
    num_chunks, bsz, m = 4, 4, 8
    lo, hi = w.span(T)
    rows = []
    for t in range(lo, hi):
        tx = _uniform((bsz * (num_chunks + 1), 1), 90 + t, dev)
        ty = torch.sin(2 * tx[:, 0])
        params = model.init_params(_uniform((m, 1), 80 + t, dev), 1, device=dev)
        params, old, moments = sgpr_absorb(model, params, None, None, tx[:bsz], ty[:bsz])
        opt = adam_init(tree_leaves(params))
        for c in range(num_chunks):
            x, y = tx[bsz * (c + 1) : bsz * (c + 2)], ty[bsz * (c + 1) : bsz * (c + 2)]
            rebase = (c + 1) % 2 == 0
            if rebase:
                leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
                with torch.enable_grad():
                    logp, trace, _, _ = sgpr_bound(model, tree_rebuild(params, leaves), old, x, y,
                                                   combine_terms=False)
                    grads = torch.autograd.grad(-(logp + trace), leaves)
                updates, opt = adam_update(grads, opt, 1e-2)
                params = tree_rebuild(params, [p.detach() + u for p, u in zip(leaves, updates)])
            with torch.no_grad():
                params, old, moments = sgpr_absorb(model, params, old, None, x, y, rebase=rebase)
        with torch.no_grad():
            mean, var = sgpr_predict(model, params, moments, tx[:bsz])
        rows.append(torch.cat([mean, var + torch.exp(params["raw_noise"])]))
    local = torch.stack(rows) if rows else torch.zeros((0, 2 * bsz), device=dev)
    return dict(trials=_flat(w.gather(T, local)))


def _fantasy_bo(w: _World) -> Dict[str, np.ndarray]:
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.wiski import WiskiModel, WiskiState, wiski_fantasize, wiski_init, wiski_predict
    from online_gp_torch.models.wiski_bayesopt import WiskiBayesOptModel
    from online_gp_torch.ops.grid import Grid
    from online_gp_torch.ops.root_update import RootCache

    dev, F, q, d = w.device, 2 * w.n_ranks, 3, 2
    grid = Grid.create([(-1.1, 1.1)] * d, 8, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(d)
    x = _uniform((32, d), 0, dev)
    y = torch.sin(3 * x[:, :1])
    state = wiski_init(model, x, y, torch.ones_like(y))
    Xq = _uniform((q, d), 10, dev)
    post = WiskiBayesOptModel(model, params, state).posterior(Xq, joint=True)
    fy = post.sample(F, generator=_gen(11)).transpose(-1, -2)  # (F, q, B)
    fx, fn = Xq[None].expand(F, q, d), torch.ones_like(fy)
    xt = _uniform((5, d), 12, dev)
    lo, hi = w.span(F)
    fant = wiski_fantasize(model, state, fx[lo:hi], fy[lo:hi], fn[lo:hi])
    stats = []
    for f in range(hi - lo):
        one = WiskiState(wty=fant.wty[f], ydy=fant.ydy[f],
                         roots=RootCache(*(None if t is None else t[f] for t in fant.roots)),
                         d_logdet=fant.d_logdet[f], num_data=fant.num_data)
        with torch.no_grad():
            mean, var = wiski_predict(model, params, one, xt)
        stats.append(torch.stack([mean.max(), var.min()]))
    local = torch.stack(stats) if stats else torch.zeros((0, 2), device=dev)
    return dict(lookahead=_flat(w.gather(F, local)))


_ARM_FNS = dict(grid_sharded=_grid_sharded, grid_sharded_iterative=_grid_sharded_iterative,
                lowrank_toeplitz=_lowrank_toeplitz, svgp_dp=_svgp_dp, localgp_experts=_localgp_experts,
                sgpr_dp=_sgpr_dp, fantasy_bo=_fantasy_bo)


def _rank_main(rank: int, world: int, device_type: str, n_ranks: int):
    """One rank of the dry run: every arm, its results as numpy arrays."""
    from online_gp_torch.parallel.mesh import local_device

    device = local_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    w = _World(rank, world, device, n_ranks)
    return {arm: _ARM_FNS[arm](w) for arm in ARMS}


def _error(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> float:
    """The largest |got - want| of an arm's arrays over max(1, their scale)."""
    err = 0.0
    for k, b in want.items():
        a = got[k]
        if a.shape != b.shape:
            return float("inf")
        scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
        err = max(err, float(np.abs(a - b).max() / scale) if b.size else 0.0)
    return err


def dryrun_multichip(n_ranks: int = 2, device_type: str = "cuda", store: str = None) -> Dict[str, float]:
    """Run every arm on ``n_ranks`` spawned gloo ranks (sharing the card on
    "cuda") and in this process, and hold each rank's results to the
    one-process run: within 1e-5 of max(1, their scale). ``store`` is a new
    FileStore path for the ranks (a fresh temporary one by default).
    Returns {arm: the largest error over the ranks}; raises AssertionError
    naming each arm over the bound."""
    from online_gp_torch.parallel.launch import spawn_ranks

    with tempfile.TemporaryDirectory(prefix="ogp_dryrun_") as tmp:
        ranks = spawn_ranks(_rank_main, n_ranks, (device_type, n_ranks), store=store or os.path.join(tmp, "store"))
    device = torch.device(device_type)
    one = _World(0, 1, device, n_ranks)
    errors = {}
    for arm in ARMS:
        want = _ARM_FNS[arm](one)
        errors[arm] = max(_error(r[arm], want) for r in ranks)
        print(f"  {arm}: {n_ranks} ranks against one process, max |d| / max(1, scale) {errors[arm]:.3e}")
    bad = {arm: e for arm, e in errors.items() if not e <= BOUND}
    assert not bad, f"dryrun_multichip({n_ranks}): arms off their one-process run by more than {BOUND}: {bad}"
    print(f"dryrun_multichip({n_ranks}) OK")
    return errors
