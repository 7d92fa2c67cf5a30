"""The WISKI core batched over independent trials, with the trial dim folded
into the output batch (the port's counterpart of ``jax.vmap`` over
``online_gp_tpu/models/wiski.py`` in ``parallel/mesh.py`` and the mesh
sweeps).

A trial-batched state is a :class:`~online_gp_torch.models.wiski.WiskiState`
whose tensors carry a leading trial dim T before the output dim B:
wty (T, B, m, 1), ydy and d_logdet (T, B), roots (T, B, m, m); ``num_data``
is one int, shared by the trials (they absorb the same number of points).
Params carry a leading T on every leaf. The x-independent pieces (the MLL,
the prediction caches) see the T * B outputs of one model as its output
batch, through a contiguous reshape, so each is one call: kernel K6 factors
Q once for all the trials. The x-dependent pieces take a stencil per trial:
the q = 1 gather of p for kernel K2 (one launch for all the trials), the
scatters into wty and the Gram accumulator, the prediction gather, the
partial MLL's interpolation columns. ``torch.func.vmap`` is not used: it
cannot pass through the ctypes kernels nor through ``_DenseInnerCore``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.priors import log_prior_sum
from online_gp_torch.models.wiski import (
    WiskiModel,
    WiskiState,
    _condition_dense,
    _second_noise,
    wiski_init,
    wiski_mll,
    wiski_prediction_caches,
)
from online_gp_torch.ops.cuda_root_update import rank1_apply
from online_gp_torch.ops.interp import interp_coeffs
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import RootCache, roots_apply_rank1_p
from online_gp_torch.utils.optim import tree_leaves, tree_rebuild


def _map_params(fn, params):
    return tree_rebuild(params, [fn(v) for v in tree_leaves(params)])


def trials_params(model: WiskiModel, num_dims: int, num_trials: int, **kw) -> Dict:
    """``model.init_params`` stacked for ``num_trials`` trials (leading T)."""
    return _map_params(lambda v: v.expand(num_trials, *v.shape).clone(), model.init_params(num_dims, **kw))


def stack_states(states: List[WiskiState]) -> WiskiState:
    """T single-trial states (one ``num_data``) as one trial-batched state."""
    if len({s.num_data for s in states}) != 1:
        raise ValueError("the trials of a batch must hold the same number of points")
    roots = RootCache(*(None if parts[0] is None else torch.stack(parts) for parts in zip(*(s.roots for s in states))))
    stack = lambda name: torch.stack([getattr(s, name) for s in states])
    return WiskiState(wty=stack("wty"), ydy=stack("ydy"), roots=roots, d_logdet=stack("d_logdet"),
                      num_data=states[0].num_data)


def fold(model: WiskiModel, params: Dict, state: WiskiState):
    """The T trials as one model of T * B outputs: (model, params, state)
    with the trial and output dims merged (views where the tensors are
    contiguous). The model's priors are left out: they are summed per trial
    by :func:`trials_mll`."""
    T, B = state.ydy.shape
    merge = lambda t: None if t is None else t.reshape(T * B, *t.shape[2:])
    folded = WiskiState(wty=merge(state.wty), ydy=merge(state.ydy), roots=RootCache(*(merge(t) for t in state.roots)),
                        d_logdet=merge(state.d_logdet), num_data=state.num_data)
    return model._replace(num_outputs=T * B, priors=None), _map_params(merge, params), folded


def _unfold(t: Optional[torch.Tensor], T: int) -> Optional[torch.Tensor]:
    return None if t is None else t.reshape(T, -1, *t.shape[1:])


def trials_init(model: WiskiModel, x: torch.Tensor, y: torch.Tensor, noise: torch.Tensor, **kw) -> WiskiState:
    """:func:`wiski_init` per trial, stacked: x (T, n, D); y, noise (T, n, B).
    Gradients flow to x as in :func:`wiski_init` (the pretrain epochs)."""
    return stack_states([wiski_init(model, x[t], y[t], noise[t], **kw) for t in range(x.shape[0])])


def trials_mll(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """:func:`wiski_mll` of every trial and output, (T, B): one call on the
    folded batch (Q on K6 once for all the trials), the priors, if any,
    added per trial."""
    T = state.ydy.shape[0]
    fmodel, fparams, fstate = fold(model, params, state)
    mll = wiski_mll(fmodel, fparams, fstate, cfg).reshape(T, -1)
    if model.priors:
        kernel = params["kernel"]
        prior = torch.stack([
            log_prior_sum(dict(model.priors), {k: v[t] for k, v in kernel.items()}, model.kernel.transforms)
            for t in range(T)
        ])
        mll = mll + prior[:, None] / float(state.num_data)
    return mll


def trials_prediction_caches(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig = DEFAULT_CONFIG):
    """:func:`wiski_prediction_caches` of every trial, one call on the folded
    batch: (mean_cache (T, B, m, 1), cov_cache (T, B, m, m) or None)."""
    T = state.ydy.shape[0]
    mean_cache, cov_cache = wiski_prediction_caches(*fold(model, params, state), cfg)
    return _unfold(mean_cache, T), _unfold(cov_cache, T)


def trials_coeffs(model: WiskiModel, x: torch.Tensor, detach: bool = True):
    """Interpolation coefficients of per-trial points x (T, n, D): idx, w
    (T, n, P)."""
    T, n, D = x.shape
    idx, w = interp_coeffs(model.grid, x.reshape(T * n, D), detach=detach)
    return idx.reshape(T, n, -1), w.reshape(T, n, -1)


def trials_dense_w(idx: torch.Tensor, w: torch.Tensor, m: int) -> torch.Tensor:
    """Per-trial :func:`~online_gp_torch.ops.interp.dense_w`: (T, n, P)
    stencils to (T, m, n) columns, duplicates summed (autograd takes it)."""
    T, n, P = idx.shape
    t_ids = torch.arange(T, device=idx.device)[:, None, None].expand(T, n, P)
    pts = torch.arange(n, device=idx.device)[None, :, None].expand(T, n, P)
    cols = torch.zeros((T, m, n), dtype=w.dtype, device=w.device)
    return cols.index_put((t_ids.reshape(-1), idx.reshape(-1), pts.reshape(-1)), w.reshape(-1), accumulate=True)


def trials_condition(
    model: WiskiModel,
    state: WiskiState,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    detach_interp: bool = True,
) -> WiskiState:
    """:func:`~online_gp_torch.models.wiski.wiski_condition` of every trial on
    its own q points: x (T, q, D); y, noise (T, q, B). At q = 1 with
    ``detach_interp`` the roots of all the trials go through one launch of
    K2 at Bd = T * B (on CUDA in place); q > 1 runs the plain rank-q update."""
    T, q, _ = x.shape
    B, m = model.num_outputs, model.grid.num_points
    y, noise = y.reshape(T, q, B), noise.reshape(T, q, B)
    idx, w = trials_coeffs(model, x, detach=detach_interp)
    if q > 1:
        return _condition_dense(state, trials_dense_w(idx, w, m), y, noise)

    root_noise = torch.sqrt(torch.clamp(noise[:, 0], min=1e-7))  # (T, B)
    dinv_y = y[:, 0] / noise[:, 0]  # (T, B)
    idx0, w0 = idx[:, 0], w[:, 0]  # (T, P)
    P = idx0.shape[-1]
    dev = idx0.device
    tt = torch.arange(T, device=dev)[:, None, None]
    bb = torch.arange(B, device=dev)[None, :, None]
    L, Binv = state.roots.root, state.roots.inv_root
    with f32_matmul_precision():
        # p[t, b] = sum_p w[t, p] inv_root[t, b, idx[t, p], :] / sqrt(noise[t, b])
        p = torch.einsum("tp,tbpm->tbm", w0, Binv[tt, bb, idx0[:, None, :]]) / root_noise[..., None]
    flat = lambda t: t.reshape(T * B, m, m).contiguous()
    if detach_interp:
        new_root, new_inv = rank1_apply(flat(L), flat(Binv), p.reshape(T * B, m).contiguous())
    else:
        new_root, new_inv = roots_apply_rank1_p(flat(L), flat(Binv), p.reshape(T * B, m))
    new_mat = state.roots.mat
    if new_mat is not None:
        outer = (w0[:, :, None] * w0[:, None, :])[:, None] / torch.clamp(noise[:, 0], min=1e-7)[..., None, None]
        shape = (T, B, P, P)
        new_mat = new_mat.index_put(
            (tt[..., None].expand(shape), bb[..., None].expand(shape),
             idx0[:, None, :, None].expand(shape), idx0[:, None, None, :].expand(shape)),
            outer, accumulate=True)
    # one scatter-add into the flat (T * B * m) wty: entry (t, b, idx[t, p])
    flat_idx = ((tt * B + bb) * m + idx0[:, None, :]).reshape(-1)
    wty = state.wty.reshape(-1).index_add(0, flat_idx, (w0[:, None, :] * dinv_y[..., None]).reshape(-1))
    return WiskiState(
        wty=wty.reshape(T, B, m, 1),
        ydy=state.ydy + y[:, 0] * dinv_y,
        roots=RootCache(mat=new_mat, root=new_root.reshape(T, B, m, m), inv_root=new_inv.reshape(T, B, m, m)),
        d_logdet=state.d_logdet + torch.log(noise[:, 0]),
        num_data=state.num_data + 1,
    )


def trials_predict(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    x: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG,
    caches: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
):
    """:func:`~online_gp_torch.models.wiski.wiski_predict` of every trial at
    its own points x (T, n, D), on the exact gather path: mean (T, B, n) and
    var (T, B, n) or None. ``caches`` from :func:`trials_prediction_caches`."""
    if cfg.fast_pred_samples:
        raise ValueError("trials_predict serves the exact gather path; fast_pred_samples is not batched over trials")
    if caches is None:
        caches = trials_prediction_caches(model, params, state, cfg)
    mean_cache, cov_cache = caches
    T, B = mean_cache.shape[:2]
    idx, w = trials_coeffs(model, x, detach=cfg.detach_interp_coeff)
    dev = idx.device
    tt = torch.arange(T, device=dev)[:, None, None, None]
    bb = torch.arange(B, device=dev)[None, :, None, None]
    it = idx[:, None]  # (T, 1, n, P)
    mean = torch.einsum("tnp,tbnp->tbn", w, mean_cache[tt, bb, it, 0])
    if cov_cache is None:
        return mean, None
    sub = cov_cache[tt[..., None], bb[..., None], it[..., :, None], it[..., None, :]]  # (T, B, n, P, P)
    var = torch.einsum("tnp,tbnpq,tnq->tbn", w, sub, w)
    s2 = _second_noise(model, params)
    if s2 is not None:
        var = var * s2[..., None]
    return mean, torch.clamp(var, min=1e-12)


def trials_partial_mll(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    new_x: torch.Tensor,
    new_y: torch.Tensor,
    caches: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """:func:`~online_gp_torch.models.partial_mll.sm_partial_mll` of every
    trial on its own points: new_x (T, q, D) differentiable features, new_y
    (T, q, B), the caches of :func:`trials_prediction_caches` (used
    detached). Returns (T, B)."""
    T, q, _ = new_x.shape
    m = model.grid.num_points
    M = caches[1].detach()  # (T, B, m, m)
    Wy = state.wty.detach()  # (T, B, m, 1)
    s2 = _second_noise(model, params)
    s2 = None if s2 is None else s2.detach()
    idx, w = trials_coeffs(model, new_x, detach=False)
    wcols = trials_dense_w(idx, w, m)[:, None]  # (T, 1, m, q)
    y = new_y.reshape(T, q, -1).mT[:, :, None, :]  # (T, B, 1, q)
    with f32_matmul_precision():
        z = Wy + wcols * y
        Mw = M @ wcols
        Mz = M @ z
    sm_div = 1.0 + torch.sum(Mw * wcols, dim=-2)  # (T, B, q)
    quad = torch.sum(z * Mz, dim=-2) - torch.sum(Mw * z, dim=-2) ** 2 / sm_div
    if s2 is not None:
        quad = quad / s2[..., None]
    per_point = (quad - torch.log(sm_div)) / 2.0
    return torch.sum(per_point, dim=-1) / (state.num_data + 1.0)
