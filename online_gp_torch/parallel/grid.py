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
beyond the rank's rows are temporaries of one call (the gathered root and
Q in the dense MLL and the caches, the gathered covariance root of the
exact caches, the gathered covariance cache of a full-rank sampling
root); the iterative MLL gathers vectors only.

Gradients across the collectives follow Megatron's pair: :func:`_reduce`
(forward all_reduce, backward identity) sums partials that feed
replicated work (Q, proj, the inducing quadratic form), and :func:`_copy`
(forward identity, backward all_reduce) marks replicated values that feed
rank-local work (the hyperparameters that build each rank's rows of
K_uu, the gathered root, the iterates of CG and Lanczos). A loss computed
the same on every rank then gets the gradient of one process.

- :func:`grid_mll_inner`: the Woodbury MLL's inner terms through
  autograd (no closed-form core, as in the JAX package's sharded branch;
  Q then needs grad, so ``spd_cholesky`` takes ``cholesky``, not K6).
  Above ``max_cholesky_size``, :func:`grid_mll_inner_iterative`: CG, SLQ
  and the Hutchinson surrogate on whole m-vectors, the same on every
  rank, through the sharded product Q v (:func:`_q_mvm`, two all_reduces).
- :func:`grid_prediction_caches`, :func:`grid_predict`: row-sharded caches
  (Q factored by K6 on the card: nothing there needs a grad; under
  ``fast_pred_var`` below full rank the LOVE root from Lanczos on the
  sharded Q v), and the moments from each rank's rows plus one all_reduce.
- :func:`grid_grid_root`, :func:`grid_predict_root`: the covariance root
  of ``fast_pred_samples`` (Lanczos on the sharded covariance cache, or
  the Cholesky factor of the gathered cache at full rank), row-sharded,
  and the interpolated root summed over the ranks.
- :func:`grid_condition_coeffs`: q = 1 sums each rank's partial p = B^T v
  by all_reduce and applies K2's row-shard entry
  (:func:`~online_gp_torch.ops.cuda_root_update.rank1_apply_rows`) to the
  local rows in place; q > 1 the same with the rank-q update in plain
  torch. The Gram and ``wty`` scatter into the local rows only.

Every rank takes the same branches and runs the same number of
iterations: CG and Lanczos run fixed counts with masks and read no value
back, and the values they branch on are replicated, with the same bits on
every rank. The collectives are all_reduce only, which gloo takes on CUDA
tensors, so two ranks may share one card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.grid_kernel import _num_components, grid_kuu_factors, grid_kuu_operator
from online_gp_torch.models import wiski as _wiski
from online_gp_torch.models.wiski import MllProbes, WiskiModel, WiskiState, _promoted, _reshape_obs, _second_noise
from online_gp_torch.ops.cg import _tridiag, batched_cg, lanczos, lanczos_root, slq_logdet
from online_gp_torch.ops.chol import chol_logdet, cho_solve, psd_safe_cholesky, spd_cholesky, tri_solve
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


def _kuu_rows_mvm(model: WiskiModel, params: Dict, lay: RowLayout, like: torch.Tensor, use_toeplitz: bool,
                  E_r: Optional[torch.Tensor] = None):
    """x (B, m, k), whole and the same on every rank -> this rank's rows of
    K_uu x / s2, (B, r, k): under ``use_toeplitz`` the Toeplitz-FFT product
    over the whole grid (every rank the same), then the rank's rows; else
    ``E_r`` (:func:`_kuu_eff_rows`, built here when not given) under a
    matmul. The params enter through :func:`_copy`; the whole K_uu is never
    built."""
    if not use_toeplitz:
        E_r = _kuu_eff_rows(model, params, lay, like) if E_r is None else E_r
        return lambda x: E_r @ x
    local = _tree_map(lambda p: _copy(p, lay), params)
    kuu = grid_kuu_operator(model.kernel, local["kernel"], model.grid, use_toeplitz=True)
    s2 = _second_noise(model, local)
    rows = slice(lay.row0, lay.row0 + lay.rows)
    if s2 is None:
        return lambda x: kuu(x)[:, rows]
    return lambda x: (kuu(x) / s2[:, None, None])[:, rows]


def _q_mvm(L_r: torch.Tensor, kuu_r, lay: RowLayout):
    """v (B, m, k), replicated -> Q v = v + L^T K L v, replicated: each
    rank's L_r v gathered (one all_reduce), this rank's rows of K (L v),
    and the partials L_r^T (K L v)_r summed (one all_reduce). v enters the
    rank-local product through :func:`_copy`."""

    def q_mvm(v):
        x = _gather(L_r @ _copy(v, lay), lay)
        return v + _reduce(L_r.mT @ kuu_r(x), lay)

    return q_mvm


# ---------------------------------------------------------------------------
# MLL, caches, predict
# ---------------------------------------------------------------------------


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


def grid_mll_inner(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig,
                   probes: Optional[MllProbes] = None):
    """(inner_qform, inner_logdet, inducing_qform), each (B,) and the same
    on every rank, of ``wiski_mll`` on a state row-sharded over
    ``cfg.grid_shard_axis``; autograd runs through the pieces. Above
    ``cfg.max_cholesky_size``, :func:`grid_mll_inner_iterative` on
    ``probes`` (``wiski_mll`` draws them)."""
    lay = state_layout(state, cfg.grid_shard_axis)
    if lay.m > cfg.max_cholesky_size:
        return grid_mll_inner_iterative(model, params, state, cfg, probes)
    _, _, Lq, _, proj, inducing_qform = _q_pieces(model, params, state, lay)
    with f32_matmul_precision():
        sol = cho_solve(Lq, proj)
        return torch.sum(proj * sol, dim=(-2, -1)), chol_logdet(Lq), inducing_qform


def grid_mll_inner_iterative(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig,
                             probes: MllProbes):
    """The CG/SLQ inner terms of ``models.wiski._mll_inner_iterative`` on a
    row-sharded state: (inner_qform, inner_logdet, inducing_qform), (B,),
    the same on every rank.

    Q v runs on the ranks' rows (:func:`_q_mvm`: K_uu by Toeplitz FFTs over
    the whole vector, or this rank's ``kuu_rows``); CG, SLQ and the
    Hutchinson surrogate run on whole m-vectors, computed alike on every
    rank, with autograd through the CG iterations. K wty comes from the
    gathered ``wty``, and the inducing quadratic form sums each rank's
    w_r . (K wty)_r. ``probes`` are the single device's
    (:func:`~online_gp_torch.models.wiski.mll_probes`), the same on every
    rank."""
    lay = state_layout(state, cfg.grid_shard_axis)
    cg_iters = min(cfg.max_cg_iterations, lay.m)
    slq_iters = min(cfg.max_root_decomposition_size, lay.m, 64)
    L_r, w_r = _local(state.roots.root), _local(state.wty)
    num_probes = probes.hutch.shape[-1]
    with f32_matmul_precision():
        kuu_r = _kuu_rows_mvm(model, params, lay, w_r, cfg.use_toeplitz)
        q_mvm = _q_mvm(L_r, kuu_r, lay)
        Kw_r = kuu_r(_gather(w_r, lay))  # (B, r, 1)
        proj = _reduce(L_r.mT @ Kw_r, lay)  # (B, m, 1)
        inducing_qform = _reduce(torch.sum(w_r * Kw_r, dim=(-2, -1)), lay)
        sol = batched_cg(q_mvm, proj, max_iters=cg_iters, tol=cfg.cg_tolerance)
        qform = torch.sum(proj * sol, dim=(-2, -1))
        with torch.no_grad():
            slq_val = slq_logdet(lambda v: q_mvm(v.mT).mT, probes.slq.to(L_r.dtype), num_iters=slq_iters)
            z = probes.hutch.to(L_r.dtype)
            qinv_z = batched_cg(q_mvm, z, max_iters=cg_iters, tol=cfg.cg_tolerance)
        surrogate = torch.sum(qinv_z * q_mvm(z), dim=(-2, -1)) / num_probes
        logdet = (slq_val - surrogate).detach() + surrogate
    return qform, logdet, inducing_qform


def grid_prediction_caches(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig):
    """``wiski_prediction_caches`` on a row-sharded state: (mean_cache,
    cov_cache) row-sharded like the state, (B, m, 1) and (B, m, m) DTensors
    of the rank's rows (cov_cache None under ``skip_posterior_variances``):

      mean_cache_r = (K wty)_r - (K L)_r Q^{-1} proj
      cov_cache_r  = K_r - R[:, r]^T R,  R = Lq^{-1} (K L)^T

    R's columns are each rank's own; the whole R is gathered for the one
    product (a temporary). Under ``fast_pred_var`` with k =
    ``max_root_decomposition_size`` < m, LOVE as the JAX package: Lanczos
    on the sharded Q v (:func:`_q_mvm`) from proj, the k x k tridiagonal's
    eigenvectors giving Rq (B, m, k) with Q^{-1} ~= Rq Rq^T, every rank the
    same; then R_r = (K L)_r Rq and cov_cache_r = K_r - R_r R^T, the
    (B, m, k) R gathered."""
    lay = state_layout(state, cfg.grid_shard_axis)
    E_r, KL_r, Lq, Kw_r, proj, _ = _q_pieces(model, params, state, lay)
    k = min(lay.m, cfg.max_root_decomposition_size)
    with f32_matmul_precision():
        mean_r = Kw_r - KL_r @ cho_solve(Lq, proj)
        if cfg.skip_posterior_variances:
            return _put(mean_r, lay), None
        if cfg.fast_pred_var and k < lay.m:
            L_r = _local(state.roots.root)
            q_mvm = _q_mvm(L_r, _kuu_rows_mvm(model, params, lay, L_r, cfg.use_toeplitz, E_r), lay)
            Qlan, alphas, betas = lanczos(lambda v: q_mvm(v[..., None])[..., 0], proj[..., 0], k)
            evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
            evals = torch.clamp(evals, min=1e-10)
            R_r = KL_r @ (Qlan.mT @ (evecs / torch.sqrt(evals)[..., None, :]))  # (B, r, k)
            return _put(mean_r, lay), _put(E_r - R_r @ _gather(R_r, lay).mT, lay)
        R_r = tri_solve(Lq, KL_r.mT)  # (B, m, r)
        cov_r = E_r - R_r.mT @ _gather(R_r, lay, dim=2)
    return _put(mean_r, lay), _put(cov_r, lay)


def _interp(model: WiskiModel, x: torch.Tensor, cfg: SolverConfig, lay: RowLayout):
    """The stencil of x; the weights, replicated, enter each rank's rows
    through :func:`_copy` (the gradient to x sums the ranks' parts)."""
    idx, w = interp_coeffs(model.grid, x, detach=cfg.detach_interp_coeff)
    return idx, _copy(w, lay)


def grid_predict(model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, cfg: SolverConfig,
                 caches: Optional[Tuple] = None):
    """``wiski_predict`` on a row-sharded state: mean = sum_r W_x[:, r]
    mean_cache_r and var = sum_r diag(W_x[:, r] C_r W_x^T), each rank's part
    from its rows and the two summed in one all_reduce; under
    ``fast_pred_samples`` the row norms of :func:`grid_predict_root`'s
    root. Returns (mean, var) (B, n), plain tensors, the same on every
    rank."""
    lay = state_layout(state, cfg.grid_shard_axis)
    if caches is None:
        caches = grid_prediction_caches(model, params, state, cfg)
    if cfg.fast_pred_samples and caches[1] is not None:
        mean, root = grid_predict_root(model, params, state, x, cfg, caches)
        return mean, torch.clamp(torch.sum(root * root, dim=-1), min=1e-12)
    mean_r, cov_r = (None if c is None else _local(c) for c in caches)
    idx, w = _interp(model, x, cfg, lay)
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


def grid_grid_root(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig,
                   caches: Optional[Tuple] = None) -> DTensor:
    """``wiski_grid_root`` on a row-sharded state: the (B, m, k) root of the
    covariance cache, row-sharded like it. Below full rank (k =
    ``max_root_decomposition_size`` < m) ``lanczos_root`` on v -> the
    gathered cov_cache_r v, started from ``root_start_vector`` (the same on
    every rank), every rank computing the whole root and keeping its rows;
    at full rank (m <= k) the jittered Cholesky factor of the gathered
    cache (a temporary), then this rank's rows."""
    lay = state_layout(state, cfg.grid_shard_axis)
    if caches is None:
        caches = grid_prediction_caches(model, params, state, cfg)
    if caches[1] is None:
        raise ValueError(
            "wiski_predict_root needs the covariance cache: unset skip_posterior_variances "
            "(mean-only configs have no root)"
        )
    cov_r = _local(caches[1])
    k = min(lay.m, cfg.max_root_decomposition_size)
    if k < lay.m:
        v0 = _wiski.root_start_vector(lay.m, cov_r.dtype, cov_r.device)
        with f32_matmul_precision():
            root = lanczos_root(
                lambda v: _gather((cov_r @ _copy(v, lay)[..., None])[..., 0], lay), v0.expand(cov_r.shape[0], lay.m), k
            )  # (B, m, k)
    else:
        root = psd_safe_cholesky(_gather(cov_r, lay), jitter=cfg.cholesky_jitter, tries=cfg.max_cholesky_jitter_tries)
    return _put(root[:, lay.row0 : lay.row0 + lay.rows].contiguous(), lay)


def grid_predict_root(model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, cfg: SolverConfig,
                      caches: Optional[Tuple] = None, grid_root: Optional[torch.Tensor] = None):
    """``wiski_predict_root`` on a row-sharded state: mean (B, n) and root
    (B, n, k), plain tensors, the same on every rank. Each rank
    interpolates its rows of the mean cache and of the grid root
    (:func:`grid_grid_root` unless ``grid_root`` is given) with its local
    stencil, one all_reduce sums the two, and the root takes sqrt(s2)."""
    lay = state_layout(state, cfg.grid_shard_axis)
    if caches is None:
        caches = grid_prediction_caches(model, params, state, cfg)
    if grid_root is None:
        grid_root = grid_grid_root(model, params, state, cfg, caches)
    idx, w = _interp(model, x, cfg, lay)
    loc, wl = shard_stencil(idx, w, lay.row0, lay.rows)
    both = _reduce(interp_matvec(loc, wl, torch.cat([_local(caches[0]), _local(grid_root)], dim=-1)), lay)
    mean, root = both[..., 0], both[..., 1:]  # (B, n), (B, n, k)
    s2 = _second_noise(model, params)
    if s2 is not None:
        root = root * torch.sqrt(s2)[..., None, None]
    return mean, root


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
    ``wty`` take the stencil's entries in the local rows. The weights enter
    through :func:`_copy`, so a gradient to them (``detach_interp=False``)
    is the one process's."""
    lay = state_layout(state, state_axis(state))
    B = model.num_outputs
    y, noise = _reshape_obs(y, noise, B)
    q = idx.shape[0]
    w = _copy(w, lay)  # replicated weights into rank-local work: the ranks' parts of their gradient summed
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
