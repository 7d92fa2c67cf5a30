"""Multi-device scaling on ``torch.distributed`` (the port of
``online_gp_tpu/parallel/mesh.py``).

The reference has no distributed backend at all: its only parallelism is
farming independent Slurm processes per trial. The JAX package batches
the independent work (trials, outputs, experts) into a leading array dim
and shards it over a device mesh, and row-shards WISKI's dense O(m^2)
state for grids past one device. Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one device per rank. DTensor stands only at the API boundary
(:func:`shard_leading`, :func:`replicate`, the sharded streams' results):
inside, every function works on each rank's local tensors with explicit
``dist.all_reduce`` calls (the counterparts of ``shard_map`` and ``psum``),
and the kernels take plain tensors. The collectives are all_reduce only,
which both NCCL and gloo take on CUDA tensors, so two ranks may share one
card over gloo.

- :func:`sharded_stream_blocked` and :func:`sharded_pred_stream_blocked`:
  WISKI's roots and predictive caches row-sharded over a ``tp`` axis, one
  all_reduce a chunk, K1's and K3's stages on the card.
- :func:`batched_trials_step`: T independent trials, the trial dim folded
  into the output batch (:mod:`online_gp_torch.parallel.trials`), so one K2
  and one K6 launch serve all the trials.
- :func:`localgp_experts_step`: the LocalGP expert dim sharded, the loss,
  the gradients and the mixture's sums all_reduced.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.models.wiski import WiskiModel, WiskiState
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.utils.optim import GradientTransformation, tree_leaves, tree_rebuild


def _open_world(device_type: str) -> None:
    """The default process group: from the environment under ``torchrun``
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), else a world of one in this
    process. NCCL for "cuda", gloo for "cpu"."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (the rank where LOCAL_RANK is
    unset), modulo the cards the process sees, so ranks that outnumber the
    cards share them; the CPU for "cpu"."""
    if device_type != "cuda":
        return torch.device(device_type)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, axis_name: str = "dp", device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over every rank of the process group,
    which is opened first if there is none (:func:`_open_world`: a world of
    one outside ``torchrun``). Each rank works on :func:`local_device`, made
    the current CUDA device. ``n_devices``, when given, must be the world
    size."""
    if not dist.is_initialized():
        _open_world(device_type)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"the mesh covers every rank of the process group: n_devices={n_devices}, world {world}")
    if device_type == "cuda":
        torch.cuda.set_device(local_device(device_type))
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(axis_name,))


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _chunk_bounds(n: int, d: int, i: int) -> Tuple[int, int]:
    """Rows [lo, hi) of part i of n rows cut into d as ``Shard(0)`` cuts them
    (``torch.chunk``: parts of ceil(n / d), the last ones shorter or empty)."""
    size = -(-n // d)
    return min(i * size, n), min((i + 1) * size, n)


def shard_leading(tree: Any, mesh: DeviceMesh, axis_name: str = "dp") -> Any:
    """Every tensor of ``tree`` with at least one dim as a DTensor sharded on
    its leading dim over ``axis_name`` (``[Shard(0)]``); 0-dim tensors
    replicated. Each rank holds the whole tensor and keeps its own rows
    (``DTensor.from_local``, no communication)."""
    d, i = mesh.size(0), mesh.get_local_rank(axis_name)

    def put(x):
        if x.dim() == 0:
            return DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        lo, hi = _chunk_bounds(x.shape[0], d, i)
        return DTensor.from_local(x[lo:hi].contiguous(), mesh, [Shard(0)], run_check=False,
                                  shape=x.shape, stride=x.stride())

    return _tree_map(put, tree)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every tensor of ``tree`` as a replicated DTensor (``[Replicate()]``)."""
    return _tree_map(lambda x: DTensor.from_local(x, mesh, [Replicate()], run_check=False), tree)


def to_local(tree: Any) -> Any:
    """Each DTensor of ``tree`` replaced by this rank's local tensor."""
    return _tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


def _row_shard(x: torch.Tensor, row0: int, rows: int) -> torch.Tensor:
    """This rank's rows [row0, row0 + rows) of x, as a contiguous copy: the
    local part of a row-sharded DTensor, or rows cut from a whole tensor
    (a plain one or a replicated DTensor)."""
    if isinstance(x, DTensor):
        if x.placements[0] == Shard(0):
            return x.to_local().clone()
        x = x.to_local()
    return x[row0 : row0 + rows].clone()


def _tp_layout(m: int, mesh: DeviceMesh, axis_name: str):
    d = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if m % d != 0:
        raise ValueError(f"grid size m={m} must divide by mesh axis size {d}")
    rows = m // d
    return mesh.get_group(axis_name), mesh.get_local_rank(axis_name) * rows, rows


def sharded_stream_blocked(
    L: torch.Tensor,
    B: torch.Tensor,
    idx: torch.Tensor,
    wv: torch.Tensor,
    mesh: DeviceMesh,
    axis_name: str = "tp",
    block: int = 128,
):
    """Tensor-parallel blocked streaming root updates: the (m, m) root and
    inverse root ROW-sharded over ``axis_name`` and updated by the blocked
    recursion of :func:`~online_gp_torch.ops.root_update.roots_stream_blocked`.

    Per rank-k chunk each rank gathers its partial p0 = S[:, rows] B[rows]
    (:func:`~online_gp_torch.ops.cuda_root_update.chunk_gather_rows`), one
    ``all_reduce`` sums the (k, m) partials, every rank runs the factor
    recursion on the sum (``chunk_factors``, O(k^2 m)) and applies it to its
    own rows (``chunk_apply_rows``): both applications contract over the
    full column axis, which every shard holds. On CUDA float32 each stage is
    K1's kernel; on the CPU its plain version. Per-rank state is 2 m^2 / d
    floats.

    Args:
      L, B: (m, m) whole tensors (each rank keeps its rows), or row-sharded
        DTensors. m must divide by the axis size.
      idx, wv: (n, P) stencil indices and weights over sqrt(noise), on every
        rank.
      mesh: a mesh with the axis ``axis_name``.

    Returns (L', B') as DTensors row-sharded over ``axis_name``.
    """
    from online_gp_torch.ops.cuda_root_update import chunk_apply_rows, chunk_factors, chunk_gather_rows
    from online_gp_torch.ops.root_update import check_stencil, pad_and_chunk_stream

    m = L.shape[-1]
    group, row0, rows = _tp_layout(m, mesh, axis_name)
    check_stencil(idx, m)
    idx_c, wv_c, k = pad_and_chunk_stream(idx, wv, block)
    idx_c = idx_c.to(torch.int32).contiguous()
    Ll, Bl = _row_shard(L, row0, rows)[None], _row_shard(B, row0, rows)[None]
    with f32_matmul_precision():
        for c in range(idx_c.shape[0]):
            p0 = chunk_gather_rows(Bl, idx_c[c], wv_c[c][None].contiguous(), row0)
            dist.all_reduce(p0, group=group)
            Ll, Bl = chunk_apply_rows(Ll, Bl, *chunk_factors(p0))
    put = lambda x: DTensor.from_local(x[0], mesh, [Shard(0)], run_check=False)
    return put(Ll), put(Bl)


def sharded_pred_stream_blocked(
    C: torch.Tensor,
    mu: torch.Tensor,
    idx: torch.Tensor,
    wv: torch.Tensor,
    y: torch.Tensor,
    nz: torch.Tensor,
    mesh: DeviceMesh,
    axis_name: str = "tp",
    block: int = 128,
):
    """Tensor-parallel blocked prequential streaming: the (m, m) predictive
    covariance cache and the (m,) mean cache ROW-sharded over ``axis_name``
    and streamed through the predict-then-condition recursion of
    :func:`~online_gp_torch.ops.pred_stream.pred_stream_blocked`.

    Per rank-k chunk each rank gathers its partials c0w = S[:, rows] C[rows]
    and mu0w = S[:, rows] mu[rows] (``pred_gather_rows``), one ``all_reduce``
    of the two packed in one buffer sums them, every rank runs the O(k^2 m)
    recursion (``pred_factors``) and updates its own rows, C -= Z[:, rows]^T Z
    and mu += Z[:, rows]^T r (``pred_apply_rows``): K3's stages on CUDA
    float32, their plain versions on the CPU.

    Args:
      C: (m, m); mu: (m,), whole (each rank keeps its rows) or row-sharded
        DTensors. m must divide by the axis size.
      idx, wv: (n, P) stencil indices and weights (not noise-scaled).
      y, nz: (n,) targets and clamped noise.

    Returns (C', mu') row-sharded over ``axis_name`` and the prequential
    moments pred_mean, pred_var (n,), replicated, all DTensors.
    """
    from online_gp_torch.ops.cuda_pred_stream import pred_apply_rows, pred_factors, pred_gather_rows
    from online_gp_torch.ops.pred_stream import _pad_chunk_aux
    from online_gp_torch.ops.root_update import check_stencil, pad_and_chunk_stream

    m = C.shape[-1]
    group, row0, rows = _tp_layout(m, mesh, axis_name)
    n = idx.shape[0]
    check_stencil(idx, m)
    idx_c, wv_c, k = pad_and_chunk_stream(idx, wv, block)
    idx_c, wv_c = idx_c.to(torch.int32).contiguous(), wv_c.contiguous()
    y_c = _pad_chunk_aux(y, k, 0.0)
    nz_c = _pad_chunk_aux(nz, k, 1.0)
    Cl, mul = _row_shard(C, row0, rows)[None], _row_shard(mu, row0, rows)[None]
    pms, pvs = [], []
    with f32_matmul_precision():
        for c in range(idx_c.shape[0]):
            c0w, mu0w = pred_gather_rows(Cl, mul, idx_c[c], wv_c[c], row0)
            packed = torch.cat([c0w.reshape(-1), mu0w.reshape(-1)])
            dist.all_reduce(packed, group=group)
            c0w, mu0w = packed[: c0w.numel()].view(c0w.shape), packed[c0w.numel() :].view(mu0w.shape)
            Z, r, pm, pv = pred_factors(idx_c[c], wv_c[c], c0w, mu0w, y_c[c][None].contiguous(),
                                        nz_c[c][None].contiguous())
            Cl, mul = pred_apply_rows(Cl, mul, Z, r, row0)
            pms.append(pm[0])
            pvs.append(pv[0])
    moments = [torch.cat(v)[:n] if v else C.new_zeros((0,)) for v in (pms, pvs)]
    rows_of = lambda x: DTensor.from_local(x[0], mesh, [Shard(0)], run_check=False)
    rep = lambda x: DTensor.from_local(x, mesh, [Replicate()], run_check=False)
    return rows_of(Cl), rows_of(mul), rep(moments[0]), rep(moments[1])


def batched_trials_step(model: WiskiModel, optimizer: GradientTransformation, cfg: SolverConfig = DEFAULT_CONFIG):
    """Build ``step(params, opt_state, state, x, y, noise) -> (params,
    opt_state, state, losses)`` over a leading trials dim: a hyper gradient
    step on -sum(wiski_mll) per trial, then ``wiski_condition`` per trial.
    ``optimizer`` is a :class:`~online_gp_torch.utils.optim.
    GradientTransformation` (``utils.optim.adam(lr)``, or a chain), as the
    JAX package's step takes an optax one.

    Every argument carries a leading T: params (each leaf), ``opt_state``
    ``optimizer.init(tree_leaves(params))``, the trial-batched state of
    :mod:`online_gp_torch.parallel.trials`, x (T, q, D), y and noise
    (T, q, B); DTensors from :func:`shard_leading` are taken as this rank's
    trials, with no communication (the trials are independent, as in the
    JAX package's sharded vmap). The trial dim is folded into the output
    batch: one K6 launch factors every trial's Q and, at q = 1, one K2
    launch conditions every trial. One elementwise optimizer (Adam, with
    or without ``zero_nans``) over the stacked params, on the sum of the
    trials' losses, is T separate ones. Returns plain tensors; losses
    (T,)."""
    from online_gp_torch.parallel.trials import trials_condition, trials_mll

    def step(params, opt_state, state: WiskiState, x, y, noise):
        params, opt_state, state, x, y, noise = to_local((params, opt_state, state, x, y, noise))
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            losses = -torch.sum(trials_mll(model, tree_rebuild(params, leaves), state, cfg), dim=-1)
            grads = torch.autograd.grad(torch.sum(losses), leaves)
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        params = tree_rebuild(params, [p.detach() + u for p, u in zip(leaves, updates)])
        state = trials_condition(model, state, x, y, noise)
        return params, opt_state, state, losses.detach()

    return step


def _all_reduce(tensors, group):
    """Sum the tensors over the group's ranks in one all_reduce (packed)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start : start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def localgp_experts_step(model, optimizer: GradientTransformation):
    """Expert-parallel LocalGP step: the joint-MLL hyper gradient step and
    the mixture prediction, with the EXPERT dim of ``LocalGPState`` sharded.

    Returns ``step(params, opt_state, state, xt) -> (params, opt_state,
    loss, mean, var)``. With a state from :func:`shard_leading` (its leaves
    DTensors sharded on E) each rank computes its experts' share of
    :func:`~online_gp_torch.models.localgp.localgp_joint_mll` and of the
    mixture; the loss and the gradient of the replicated params are summed
    by ``all_reduce`` (as DDP sums), and so, before the division, are the
    mixture's normaliser sum_E w and its sums sum_E w mean and
    sum_E w (var + mean^2). Every rank then takes the same step of
    ``optimizer`` (a :class:`~online_gp_torch.utils.optim.
    GradientTransformation`; ``opt_state`` from
    ``optimizer.init(tree_leaves(params))``). With plain
    tensors it is the one-process step. :func:`localgp_mixture` also returns
    each rank's per-expert statistics, sharded on E."""
    from online_gp_torch.models.localgp import localgp_joint_mll

    def step(params, opt_state, state, xt):
        group = _group_of(state)
        params, opt_state, state, xt = to_local((params, opt_state, state, xt))
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = -localgp_joint_mll(model, tree_rebuild(params, leaves), state)
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if group is not None:
            loss, *grads = _all_reduce([loss, *grads], group)
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        params = tree_rebuild(params, [p.detach() + u for p, u in zip(leaves, updates)])
        with torch.no_grad():
            mean, var, _ = localgp_mixture(model, params, state, xt, group)
        return params, opt_state, loss, mean, var

    return step


def _group_of(tree):
    """The process group of the first DTensor in ``tree`` (None if none)."""
    found = []
    _tree_map(lambda x: found.append(x) if isinstance(x, DTensor) else None, tree)
    return found[0].device_mesh.get_group(0) if found else None


def localgp_mixture(model, params: Dict, state, xt: torch.Tensor, group=None):
    """The LocalGP mixture posterior at xt over experts sharded across
    ``group``'s ranks (``state`` this rank's experts): mean (n,), variance
    (n,) and this rank's per-expert statistics (normalised weights, means,
    variances, each (n, E_local)). The normaliser and the two weighted sums
    are summed over the ranks before the division; with ``group`` None it
    is one process's mixture over its experts."""
    from online_gp_torch.models.localgp import localgp_expert_moments

    w, means, yvar = localgp_expert_moments(model, params, state, xt)
    sums = [torch.sum(w, dim=-1), torch.sum(w * means, dim=-1), torch.sum(w * (yvar + means**2), dim=-1)]
    if group is not None:
        sums = _all_reduce(sums, group)
    norm, s_mean, s_sq = sums
    mix_mean = s_mean / norm
    mix_var = torch.clamp(s_sq / norm - mix_mean**2, min=1e-12)
    return mix_mean, mix_var, (w / norm[:, None], means, yvar)
