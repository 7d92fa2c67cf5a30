"""Grid-sharded WISKI: the inducing-grid dimension m row-sharded over a
mesh axis, for grids past one device's memory (``SolverConfig(
grid_shard_axis=...)``; the port of the JAX package's ``grid_shard_axis``
branches of ``models/wiski.py``, which GSPMD partitions).

Layout. ``wty``, ``roots.mat``, ``roots.root`` and ``roots.inv_root`` are
sharded on their m rows over the axis: at the API boundary DTensors with
``Shard(1)`` on it (:func:`shard_wiski_state`), each rank holding m / d
rows of every output. ``ydy``, ``d_logdet`` and ``num_data`` are
replicated plain values. Q = I + L^T K L (m x m, contracted over the grid)
and its Cholesky factor are replicated. Inside, every function works on
the local rows with explicit ``all_reduce`` calls; the only m x m tensors
beyond the rank's rows are temporaries of one call (the gathered root in
the MLL, the gathered covariance root in the caches, Q).

Gradients across the collectives follow Megatron's pair: :func:`_reduce`
(forward all_reduce, backward identity) sums partials that feed
replicated work (Q, proj, the inducing quadratic form), and :func:`_copy`
(forward identity, backward all_reduce) marks replicated values that feed
rank-local work (the hyperparameters that build each rank's rows of
K_uu, the gathered root). A loss computed the same on every rank then
gets the gradient of one process.

- :func:`grid_mll_inner`: the Woodbury MLL's inner terms through
  autograd (no closed-form core, as in the JAX package's sharded branch;
  Q then needs grad, so ``spd_cholesky`` takes ``cholesky``, not K6).
- :func:`grid_prediction_caches`, :func:`grid_predict`: row-sharded caches
  (Q factored by K6 on the card: nothing there needs a grad), and the
  moments from each rank's rows plus one all_reduce.
- :func:`grid_condition_coeffs`: q = 1 sums each rank's partial p = B^T v
  by all_reduce and applies K2's row-shard entry
  (:func:`~online_gp_torch.ops.cuda_root_update.rank1_apply_rows`) to the
  local rows in place; q > 1 the same with the rank-q update in plain
  torch. The Gram and ``wty`` scatter into the local rows only.

The collectives are all_reduce only, which gloo takes on CUDA tensors, so
two ranks may share one card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.grid_kernel import _num_components, grid_kuu_factors
from online_gp_torch.models.wiski import WiskiModel, WiskiState, _promoted, _reshape_obs, _second_noise
from online_gp_torch.ops.chol import chol_logdet, cho_solve, spd_cholesky, tri_solve
from online_gp_torch.ops.cuda_root_update import rank1_apply_rows, shard_stencil
from online_gp_torch.ops.interp import dense_w, interp_coeffs, interp_matvec
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import RootCache, roots_apply_rank1_p, roots_apply_rank_q_p
from online_gp_torch.parallel.mesh import _tree_map


class RowLayout(NamedTuple):
    """Where this rank's rows lie: the DTensor's mesh and placements, the
    axis's process group and size, and rows [row0, row0 + rows) of m."""

    mesh: object
    placements: tuple
    group: object
    size: int
    row0: int
    rows: int
    m: int


# ---------------------------------------------------------------------------
# layout and the boundary
# ---------------------------------------------------------------------------


def _axis_dim(mesh, axis_name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"grid_shard_axis={axis_name!r}: the mesh has no axis {axis_name!r} (axes {names})")
    return names.index(axis_name)


def _layout(mesh, axis_name: str, m: int) -> RowLayout:
    dim = _axis_dim(mesh, axis_name)
    d = mesh.size(dim)
    if m % d != 0:
        raise ValueError(f"grid_shard_axis={axis_name!r}: grid size m={m} must divide by the axis size {d}")
    rows = m // d
    placements = tuple(Shard(1) if i == dim else Replicate() for i in range(mesh.ndim))
    return RowLayout(mesh, placements, mesh.get_group(axis_name), d, mesh.get_local_rank(axis_name) * rows, rows, m)


def _sharded_on(x, axis_name: str) -> bool:
    if not isinstance(x, DTensor):
        return False
    names = x.device_mesh.mesh_dim_names or ()
    return axis_name in names and x.placements[names.index(axis_name)] == Shard(1)


def state_axis(state: WiskiState) -> str:
    """The mesh axis a grid-sharded state's rows are sharded on."""
    x = state.roots.root
    names = x.device_mesh.mesh_dim_names or ()
    for name, pl in zip(names, x.placements):
        if pl == Shard(1):
            return name
    raise ValueError("the state's roots are DTensors but not row-sharded (Shard(1)) on any mesh axis")


def state_layout(state: WiskiState, axis_name: str) -> RowLayout:
    """The :class:`RowLayout` of a state row-sharded on ``axis_name``;
    ValueError naming the axis when a tensor is not sharded on it or m does
    not divide by its size."""
    tensors = dict(wty=state.wty, root=state.roots.root, inv_root=state.roots.inv_root)
    if state.roots.mat is not None:
        tensors["mat"] = state.roots.mat
    for name, x in tensors.items():
        if not _sharded_on(x, axis_name):
            raise ValueError(
                f"grid_shard_axis={axis_name!r}: the state's {name} is not row-sharded on mesh axis "
                f"{axis_name!r} (Shard(1)); shard it with parallel.grid.shard_wiski_state"
            )
    root = state.roots.root
    return _layout(root.device_mesh, axis_name, root.shape[-1])


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _put(x: torch.Tensor, lay: RowLayout) -> DTensor:
    shape = (x.shape[0], lay.m, *x.shape[2:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(x, lay.mesh, lay.placements, run_check=False, shape=shape, stride=stride)


def shard_wiski_state(state: WiskiState, mesh, axis_name: str = "tp") -> WiskiState:
    """A whole state (every rank holding it) row-sharded over ``axis_name``:
    ``wty`` and the roots become DTensors with ``Shard(1)``, each rank
    keeping a contiguous copy of its m / d rows; the rest stays. m must
    divide by the axis size."""
    lay = _layout(mesh, axis_name, state.roots.root.shape[-1])
    rows = lambda x: None if x is None else _put(_local(x)[:, lay.row0 : lay.row0 + lay.rows].contiguous(), lay)
    return state._replace(
        wty=rows(state.wty),
        roots=RootCache(mat=rows(state.roots.mat), root=rows(state.roots.root), inv_root=rows(state.roots.inv_root)),
    )


def gather_rows(x: torch.Tensor, lay: RowLayout) -> torch.Tensor:
    """The whole (B, m, ...) tensor from each rank's rows (one all_reduce
    of a zero-filled buffer; gloo takes CUDA tensors for all_reduce only)."""
    x = _local(x)
    full = x.new_zeros((x.shape[0], lay.m, *x.shape[2:]))
    full[:, lay.row0 : lay.row0 + lay.rows] = x
    if lay.size > 1:
        dist.all_reduce(full, group=lay.group)
    return full


def gather_wiski_state(state: WiskiState) -> WiskiState:
    """A grid-sharded state as whole tensors on every rank."""
    if not isinstance(state.roots.root, DTensor):
        return state
    lay = state_layout(state, state_axis(state))
    whole = lambda x: None if x is None else gather_rows(x, lay)
    return state._replace(
        wty=whole(state.wty),
        roots=RootCache(mat=whole(state.roots.mat), root=whole(state.roots.root),
                        inv_root=whole(state.roots.inv_root)),
    )


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------


class _Reduce(torch.autograd.Function):
    """Forward all_reduce, backward identity: partial sums whose total
    feeds work every rank repeats."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Forward identity, backward all_reduce: a replicated value that feeds
    rank-local work, whose cotangent is the sum of the ranks' parts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _reduce(x: torch.Tensor, lay: RowLayout) -> torch.Tensor:
    return _Reduce.apply(x, lay.group) if lay.size > 1 else x


def _copy(x: torch.Tensor, lay: RowLayout) -> torch.Tensor:
    return _Copy.apply(x, lay.group) if lay.size > 1 and x.requires_grad else x


def _gather(x: torch.Tensor, lay: RowLayout, dim: int = 1) -> torch.Tensor:
    """The whole tensor along ``dim`` from each rank's slice, for rank-local
    work: zero-padded, reduced, copied (backward: all_reduce, then the
    rank's slice)."""
    if lay.size == 1:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [lay.row0, lay.m - lay.row0 - lay.rows]
    return _copy(_reduce(torch.nn.functional.pad(x, pad), lay), lay)


# ---------------------------------------------------------------------------
# K_uu's rows
# ---------------------------------------------------------------------------


def kuu_rows(model: WiskiModel, params: Dict, row0: int, rows: int) -> torch.Tensor:
    """Rows [row0, row0 + rows) of the dense K_uu, (..., rows, m), from the
    per-dimension factors' rows: grid row i is the multi-index
    (i // stride_d) % m_d, and its row of T_0 ⊗ ... ⊗ T_{D-1} the Kronecker
    product of the factors' rows, taken in ``kron_dense``'s order (the same
    products, so equal to those rows of ``grid_kuu_dense``)."""
    grid = model.grid
    i = torch.arange(row0, row0 + rows, device=grid.mins.device)

    def rows_of(factors):
        out = None
        for d, f in enumerate(factors):
            fr = f[..., (i // grid.strides[d]) % grid.sizes[d], :]  # (..., rows, m_d)
            if out is None:
                out = fr
            else:
                b = torch.broadcast_shapes(out.shape[:-2], fr.shape[:-2])
                out = (out[..., :, :, None] * fr[..., :, None, :]).reshape(*b, rows, -1)
        return out

    nc = _num_components(model.kernel)
    if nc == 1:
        return rows_of(grid_kuu_factors(model.kernel, params["kernel"], grid))
    out = rows_of(grid_kuu_factors(model.kernel, params["kernel"], grid, component=0))
    for q in range(1, nc):
        out = out + rows_of(grid_kuu_factors(model.kernel, params["kernel"], grid, component=q))
    return out


def _kuu_eff_rows(model: WiskiModel, params: Dict, lay: RowLayout, like: torch.Tensor) -> torch.Tensor:
    """This rank's rows of K_uu / s2, promoted to the dtype of ``like`` (as
    ``models.wiski._kuu_eff``); the params enter through :func:`_copy`."""
    local = _tree_map(lambda p: _copy(p, lay), params)
    E = kuu_rows(model, local, lay.row0, lay.rows)
    s2 = _second_noise(model, local)
    if s2 is not None:
        E = E / s2[..., None, None]
    return E.to(torch.promote_types(E.dtype, like.dtype))


# ---------------------------------------------------------------------------
# MLL, caches, predict
# ---------------------------------------------------------------------------


def _check_cfg(cfg: SolverConfig, m: int, caches: bool) -> None:
    if m > cfg.max_cholesky_size:
        raise ValueError(
            f"grid_shard_axis={cfg.grid_shard_axis!r} runs the dense Woodbury path: m={m} must be "
            f"<= max_cholesky_size={cfg.max_cholesky_size}"
        )
    if caches and (cfg.fast_pred_var or cfg.fast_pred_samples):
        raise ValueError(f"grid_shard_axis={cfg.grid_shard_axis!r} builds the exact caches: unset fast_pred_var "
                         "and fast_pred_samples")


def _q_pieces(model: WiskiModel, params: Dict, state: WiskiState, lay: RowLayout):
    """(E_r, K L rows, chol(Q), K wty rows, proj, wty^T K wty), Q and proj
    summed over the ranks; TF32 off."""
    L_r, w_r = _local(state.roots.root), _local(state.wty)
    with f32_matmul_precision():
        E_r = _kuu_eff_rows(model, params, lay, w_r)  # (B, r, m)
        KL_r = E_r @ _gather(L_r, lay)  # (B, r, m)
        Kw_r = E_r @ _gather(w_r, lay)  # (B, r, 1)
        eye = torch.eye(lay.m, dtype=KL_r.dtype, device=KL_r.device)
        Lq = spd_cholesky(eye + _reduce(L_r.mT @ KL_r, lay))
        proj = _reduce(L_r.mT @ Kw_r, lay)  # (B, m, 1)
        inducing_qform = _reduce(torch.sum(w_r * Kw_r, dim=(-2, -1)), lay)
    return E_r, KL_r, Lq, Kw_r, proj, inducing_qform


def grid_mll_inner(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig):
    """(inner_qform, inner_logdet, inducing_qform), each (B,) and the same
    on every rank, of ``wiski_mll`` on a state row-sharded over
    ``cfg.grid_shard_axis``; autograd runs through the pieces."""
    lay = state_layout(state, cfg.grid_shard_axis)
    _check_cfg(cfg, lay.m, caches=False)
    _, _, Lq, _, proj, inducing_qform = _q_pieces(model, params, state, lay)
    with f32_matmul_precision():
        sol = cho_solve(Lq, proj)
        return torch.sum(proj * sol, dim=(-2, -1)), chol_logdet(Lq), inducing_qform


def grid_prediction_caches(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig):
    """``wiski_prediction_caches`` on a row-sharded state: (mean_cache,
    cov_cache) row-sharded like the state, (B, m, 1) and (B, m, m) DTensors
    of the rank's rows (cov_cache None under ``skip_posterior_variances``):

      mean_cache_r = (K wty)_r - (K L)_r Q^{-1} proj
      cov_cache_r  = K_r - R[:, r]^T R,  R = Lq^{-1} (K L)^T

    R's columns are each rank's own; the whole R is gathered for the one
    product (a temporary)."""
    lay = state_layout(state, cfg.grid_shard_axis)
    _check_cfg(cfg, lay.m, caches=True)
    E_r, KL_r, Lq, Kw_r, proj, _ = _q_pieces(model, params, state, lay)
    with f32_matmul_precision():
        mean_r = Kw_r - KL_r @ cho_solve(Lq, proj)
        if cfg.skip_posterior_variances:
            return _put(mean_r, lay), None
        R_r = tri_solve(Lq, KL_r.mT)  # (B, m, r)
        cov_r = E_r - R_r.mT @ _gather(R_r, lay, dim=2)
    return _put(mean_r, lay), _put(cov_r, lay)


def grid_predict(model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, cfg: SolverConfig,
                 caches: Optional[Tuple] = None):
    """``wiski_predict`` on a row-sharded state: mean = sum_r W_x[:, r]
    mean_cache_r and var = sum_r diag(W_x[:, r] C_r W_x^T), each rank's part
    from its rows and the two summed in one all_reduce. Returns (mean,
    var) (B, n), plain tensors, the same on every rank."""
    lay = state_layout(state, cfg.grid_shard_axis)
    if caches is None:
        caches = grid_prediction_caches(model, params, state, cfg)
    mean_r, cov_r = (None if c is None else _local(c) for c in caches)
    idx, w = interp_coeffs(model.grid, x, detach=cfg.detach_interp_coeff)
    loc, wl = shard_stencil(idx, w, lay.row0, lay.rows)
    mean = interp_matvec(loc, wl, mean_r)[..., 0]  # (B, n)
    if cov_r is None:
        return _reduce(mean, lay), None
    sub = cov_r[..., loc[:, :, None], idx[:, None, :]]  # (B, n, P, P)
    var = torch.einsum("np,...npq,nq->...n", wl, sub, w)
    n = mean.shape[-1]
    both = _reduce(torch.cat([mean, var], dim=-1), lay)
    mean, var = both[..., :n], both[..., n:]
    s2 = _second_noise(model, params)
    if s2 is not None:
        var = var * s2[..., None]
    return mean, torch.clamp(var, min=1e-12)


# ---------------------------------------------------------------------------
# conditioning
# ---------------------------------------------------------------------------


def grid_condition_coeffs(model: WiskiModel, state: WiskiState, idx: torch.Tensor, w: torch.Tensor,
                          y: torch.Tensor, noise: torch.Tensor, detach_interp: bool = True) -> WiskiState:
    """``wiski_condition_coeffs`` on a row-sharded state. Each rank forms its
    partial p = sum over its rows of B^T v, one all_reduce sums them, and
    the root update runs on the local rows: at q = 1 through K2's row-shard
    entry (with ``detach_interp``; in place on CUDA) or its plain version
    (without), at q > 1 the rank-q update in plain torch. The Gram and
    ``wty`` take the stencil's entries in the local rows."""
    lay = state_layout(state, state_axis(state))
    B = model.num_outputs
    y, noise = _reshape_obs(y, noise, B)
    q = idx.shape[0]
    L_r, Bi_r, w_r = _local(state.roots.root), _local(state.roots.inv_root), _local(state.wty)
    A_r = None if state.roots.mat is None else _local(state.roots.mat)
    root_noise = torch.sqrt(torch.clamp(noise, min=1e-7))  # (q, B)
    dinv_y = y / noise
    if q == 1:
        idx0, w0 = idx[0], w[0]
        loc, wl = shard_stencil(idx0, w0, lay.row0, lay.rows)
        with f32_matmul_precision():
            p = torch.einsum("p,bpm->bm", wl, Bi_r[:, loc, :]) / root_noise[0][:, None]
        p = _copy(_reduce(p, lay), lay)
        if detach_interp:
            L_r, Bi_r = rank1_apply_rows(L_r.contiguous(), Bi_r.contiguous(), p.contiguous())
        else:
            L_r, Bi_r = roots_apply_rank1_p(L_r, Bi_r, p)
        if A_r is not None:
            P = idx0.shape[0]
            outer = (wl[:, None] * w0[None, :])[None] / torch.clamp(noise[0], min=1e-7)[:, None, None]
            bidx = torch.arange(B, device=idx0.device)
            A_r = A_r.index_put(
                (bidx[:, None, None].expand(B, P, P), loc[None, :, None].expand(B, P, P),
                 idx0[None, None, :].expand(B, P, P)),
                outer, accumulate=True,
            )
        w_r = w_r[..., 0].index_add(1, loc, wl[None, :] * dinv_y[0][:, None])[..., None]
    else:
        loc, wl = shard_stencil(idx, w, lay.row0, lay.rows)
        cols_r = dense_w(loc, wl, lay.rows)  # (r, q)
        v_r = cols_r[None] / root_noise.mT[:, None, :]  # (B, r, q)
        with f32_matmul_precision():
            p = _copy(_reduce(Bi_r.mT @ v_r, lay), lay)  # (B, m, q)
            L_r, Bi_r = roots_apply_rank_q_p(L_r, Bi_r, p)
            if A_r is not None:
                v = dense_w(idx, w, lay.m)[None] / root_noise.mT[:, None, :]  # (B, m, q)
                A_r = A_r + v_r @ v.mT
            w_r = w_r + torch.einsum("mq,qb->bm", *_promoted(cols_r, dinv_y))[..., None]
    return WiskiState(
        wty=_put(w_r, lay),
        ydy=state.ydy + torch.sum(y * dinv_y, dim=0),
        roots=RootCache(mat=None if A_r is None else _put(A_r, lay), root=_put(L_r, lay), inv_root=_put(Bi_r, lay)),
        d_logdet=state.d_logdet + torch.sum(torch.log(noise), dim=0),
        num_data=state.num_data + q,
    )
