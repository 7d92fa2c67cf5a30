"""WISKI, the constant-time online SKI GP, as a functional PyTorch core
(port of ``online_gp_tpu/models/wiski.py``, the serving side).

  state ("kernel cache"):
    wty      = W D^{-1} y          (B, m, 1)
    ydy      = y^T D^{-1} y        (B,)
    roots    = RootCache over A = W D^{-1} W^T (B, m, m)
    d_logdet = log|D|              (B,)
    num_data = n                   (python int)

  transforms:
    wiski_init, wiski_condition, wiski_stream    build and absorb
    wiski_expand, wiski_fantasize,
    wiski_condition_batched                      F fantasy copies, conditioned
    wiski_mll                                    Woodbury MLL, closed-form backward
    wiski_prediction_caches, wiski_predict       serve predictions
    wiski_grid_root, wiski_predict_root          joint-covariance roots for sampling
    wiski_pred_cache_condition,
    wiski_prequential_stream                     evaluate-then-condition

B is the output batch. The learnable second noise s2 divides K_uu inside
all cache algebra and rescales the predictive covariance at the end.

Dtypes follow the JAX package's promotion: the params may be float32
while the state follows the data's dtype (float64 in the parity tests);
K_uu is promoted to the state's dtype where the two meet in a product.

Eager PyTorch in place of jitted JAX: the functions take and return
NamedTuple states like the JAX package, but the hot loops update tensors
in place where a CUDA kernel does the work (the roots in
``wiski_condition`` and ``wiski_stream``, the caches in
``wiski_prequential_stream``). Treat a state or caches passed in as
consumed. On the CPU the plain versions run and nothing is overwritten.

``detach_interp`` routes the conditioning as it does in the JAX package.
True (every entry point of the wrappers): kernels K2, K1 and K3 on CUDA
float32 tensors, their plain versions on the CPU. False (the
differentiable route of fantasies and acquisitions): the interpolation
weights keep their gradient, and the same math runs in forms autograd
takes, on any device, never a kernel and never in place. The route is
the argument alone.

Q = I + L^T K L, the matrix of the MLL and the prediction caches, is
factored by :func:`online_gp_torch.ops.chol.spd_cholesky`: kernel K6 on
the card wherever Q needs no grad (the MLL's forward inside
:class:`_DenseInnerCore`, caches built under ``torch.no_grad()``).

Above ``cfg.max_cholesky_size`` the MLL runs iteratively
(:func:`_mll_inner_iterative`): batched CG for the quadratic form, SLQ
for log|Q| with a Hutchinson surrogate for its gradient, and K_uu
products that are dense or Toeplitz-FFT by ``cfg.use_toeplitz``. Its
Rademacher probes are an explicit argument (:func:`mll_probes`), where
the JAX package takes a PRNG key. ``fast_pred_var`` below full rank
builds a LOVE (Lanczos) covariance root, and ``fast_pred_samples``
predicts through :func:`wiski_predict_root`.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel
from online_gp_torch.kernels.grid_kernel import grid_kuu_dense, grid_kuu_operator
from online_gp_torch.kernels.priors import log_prior_sum
from online_gp_torch.logging.timing import spanned
from online_gp_torch.ops.cg import batched_cg, lanczos, lanczos_root, rademacher, slq_logdet
from online_gp_torch.ops.chol import cho_solve, chol_logdet, psd_safe_cholesky, spd_cholesky, tri_solve
from online_gp_torch.ops.cuda_root_update import rank1_apply
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import dense_w, gather_predict, interp_coeffs, interp_matvec, wt_matvec
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.pred_stream import pred_stream_blocked_batched
from online_gp_torch.ops.root_update import (
    RootCache,
    root_cache_expand,
    root_cache_init,
    root_cache_rebuild_mat,
    root_cache_slim,
    root_cache_update,
    roots_apply_rank1_p,
    roots_stream_blocked_batched,
)

LOG_2PI = 1.8378770664093453


class WiskiModel(NamedTuple):
    """Static model spec."""

    kernel: Kernel
    grid: Grid
    num_outputs: int
    learn_additional_noise: bool = False
    priors: Optional[tuple] = None

    def init_params(self, num_dims: int, dtype=torch.float32, device=None, **kw) -> Dict:
        """Default params, on the grid's device unless ``device`` is given."""
        device = self.grid.device if device is None else device
        batch = (self.num_outputs,)
        params = {
            "kernel": self.kernel.init_params(num_dims, batch, dtype=dtype, device=device, **kw)
        }
        if self.learn_additional_noise:
            params["raw_second_noise"] = torch.zeros(batch, dtype=dtype, device=device)
        return params


class WiskiState(NamedTuple):
    wty: torch.Tensor  # (B, m, 1)
    ydy: torch.Tensor  # (B,)
    roots: RootCache  # tensors (B, m, m)
    d_logdet: torch.Tensor  # (B,)
    num_data: int


def _second_noise(model: WiskiModel, params: Dict) -> Optional[torch.Tensor]:
    if model.learn_additional_noise:
        return torch.exp(params["raw_second_noise"])  # (B,)
    return None


def _reshape_obs(y: torch.Tensor, noise: torch.Tensor, num_outputs: int):
    """Normalize targets/noise to (n, B)."""
    return y.reshape(-1, num_outputs), noise.reshape(-1, num_outputs)


def _grid_sharded(state: WiskiState) -> bool:
    """True when the state's roots are DTensors, row-sharded over a mesh
    axis (:mod:`online_gp_torch.parallel.grid`)."""
    return isinstance(state.roots.root, DTensor)


def _refuse_grid_sharded(state: WiskiState, what: str, sharded: str) -> None:
    if _grid_sharded(state):
        from online_gp_torch.parallel.grid import state_axis

        raise ValueError(
            f"{what} takes a whole state; this one is row-sharded over mesh axis {state_axis(state)!r}: "
            f"stream a row-sharded state with online_gp_torch.parallel.{sharded}"
        )


def _grid_axis(state: WiskiState, cfg: SolverConfig) -> Optional[str]:
    """The mesh axis of the grid-sharded path, or None for the whole state;
    ValueError when the state and ``cfg.grid_shard_axis`` disagree."""
    if cfg.grid_shard_axis is None and _grid_sharded(state):
        from online_gp_torch.parallel.grid import state_axis

        axis = state_axis(state)
        raise ValueError(
            f"the state is row-sharded over mesh axis {axis!r}: pass SolverConfig(grid_shard_axis={axis!r})"
        )
    return cfg.grid_shard_axis


def _promoted(*ts: torch.Tensor):
    """The tensors in their common dtype, as the JAX package's products
    promote (float32 targets and noise beside float64 features)."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in ts)


# ---------------------------------------------------------------------------
# init and conditioning
# ---------------------------------------------------------------------------


def wiski_init(
    model: WiskiModel,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    root_jitter: float = 1e-4,
    chunk: int = 4096,
    detach_interp: bool = False,
) -> WiskiState:
    """Build the O(m^2) caches from initial data.

    Args:
      x: (n, D) inputs; y, noise: (n, B) targets and fixed noise diagonal.
    """
    B = model.num_outputs
    m = model.grid.num_points
    y, noise = _reshape_obs(y, noise, B)
    n = x.shape[0]
    f = dict(dtype=x.dtype, device=x.device)
    wty = torch.zeros((B, m, 1), **f)
    ydy = torch.zeros((B,), **f)
    A = torch.zeros((B, m, m), **f)
    with f32_matmul_precision():
        for start in range(0, n, chunk):
            xs = x[start : start + chunk]
            ys = y[start : start + chunk]
            ns = noise[start : start + chunk]
            idx, w = interp_coeffs(model.grid, xs, detach=detach_interp)
            wt = dense_w(idx, w, m)  # (m, c)
            dinv_y = ys / ns  # (c, B)
            wty = wty + torch.einsum("mc,cb->bm", *_promoted(wt, dinv_y))[..., None]
            ydy = ydy + torch.sum(ys * dinv_y, dim=0)
            # 1 / noise in the noise's dtype, then the product, as the JAX
            # package computes it (float32 noise beside float64 inputs)
            A = A + torch.einsum("bmc,kc->bmk", *_promoted(wt[None] * (1.0 / ns).T[:, None, :], wt))
    d_logdet = torch.sum(torch.log(noise), dim=0)
    roots = root_cache_init(A, jitter=root_jitter)
    return WiskiState(wty=wty, ydy=ydy, roots=roots, d_logdet=d_logdet, num_data=n)


def wiski_condition(
    model: WiskiModel,
    state: WiskiState,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    detach_interp: bool = True,
) -> WiskiState:
    """Absorb q new observations in O(m^2 q), with the noise clamped at
    1e-7 before the root update. At q = 1 with ``detach_interp`` the roots
    go through K2 (on CUDA in place); without it, through the plain update,
    which autograd takes."""
    idx, w = interp_coeffs(model.grid, x, detach=detach_interp)
    return wiski_condition_coeffs(model, state, idx, w, y, noise, detach_interp)


def wiski_condition_coeffs(
    model: WiskiModel,
    state: WiskiState,
    idx: torch.Tensor,
    w: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    detach_interp: bool = True,
) -> WiskiState:
    """:func:`wiski_condition` given interpolation coefficients
    (``idx``/``w``: (q, P) from :func:`interp_coeffs`); ``detach_interp``
    routes the q = 1 root update (K2, or the plain update autograd takes).
    A state whose roots are row-sharded DTensors
    (:func:`online_gp_torch.parallel.grid.shard_wiski_state`) is
    conditioned on each rank's rows
    (:func:`~online_gp_torch.parallel.grid.grid_condition_coeffs`)."""
    if _grid_sharded(state):
        from online_gp_torch.parallel.grid import grid_condition_coeffs

        return grid_condition_coeffs(model, state, idx, w, y, noise, detach_interp)
    B = model.num_outputs
    m = model.grid.num_points
    y, noise = _reshape_obs(y, noise, B)
    q = idx.shape[0]
    if q > 1:
        return _condition_dense(state, dense_w(idx, w, m), y, noise)

    # q = 1: the update vector v = W_x / sqrt(D) has P = 4^D nonzeros: p =
    # B^T v is a P-row gather of the inverse root, and the Gram and wty
    # updates are P-sized scatters; the O(m^2) work is K2's two outer products
    root_noise = torch.sqrt(torch.clamp(noise, min=1e-7))  # (1, B)
    dinv_y = y / noise  # (1, B)
    idx0, w0 = idx[0], w[0]
    P = idx0.shape[0]
    with f32_matmul_precision():
        p = torch.einsum("p,bpm->bm", w0, state.roots.inv_root[:, idx0, :]) / root_noise[0][:, None]
    if detach_interp:
        new_root, new_inv = rank1_apply(
            state.roots.root.contiguous(), state.roots.inv_root.contiguous(), p.contiguous()
        )
    else:
        # K2 has no autograd rule (nor has the Pallas kernel in JAX)
        new_root, new_inv = roots_apply_rank1_p(state.roots.root, state.roots.inv_root, p)
    if state.roots.mat is None:
        new_mat = None
    else:
        outer = (w0[:, None] * w0[None, :])[None] / torch.clamp(noise[0], min=1e-7)[:, None, None]
        bidx = torch.arange(B, device=idx0.device)
        new_mat = state.roots.mat.index_put(
            (
                bidx[:, None, None].expand(B, P, P),
                idx0[None, :, None].expand(B, P, P),
                idx0[None, None, :].expand(B, P, P),
            ),
            outer,
            accumulate=True,
        )
    # one scatter-add kernel (duplicates summed); index_put with
    # accumulate=True sorts its indices first, in several launches
    wty = state.wty[..., 0].index_add(1, idx0, w0[None, :] * dinv_y[0][:, None])[..., None]
    return WiskiState(
        wty=wty,
        ydy=state.ydy + torch.sum(y * dinv_y, dim=0),
        roots=RootCache(mat=new_mat, root=new_root, inv_root=new_inv),
        d_logdet=state.d_logdet + torch.sum(torch.log(noise), dim=0),
        num_data=state.num_data + 1,
    )


def _condition_dense(state: WiskiState, w_cols: torch.Tensor, y: torch.Tensor, noise: torch.Tensor) -> WiskiState:
    """Rank-q conditioning on dense interpolation columns w_cols (..., m, q)
    with y, noise (..., q, B), for a state whose tensors carry the same
    leading dims: :func:`root_cache_update` (plain, autograd takes it) on
    v = W / sqrt(D), and the additive caches."""
    root_noise = torch.sqrt(torch.clamp(noise, min=1e-7))  # (..., q, B)
    dinv_y = y / noise
    v = w_cols[..., None, :, :] / root_noise.mT[..., :, None, :]  # (..., B, m, q)
    roots = root_cache_update(state.roots, v)
    with f32_matmul_precision():
        wty = state.wty + torch.einsum("...mq,...qb->...bm", *_promoted(w_cols, dinv_y))[..., None]
    return WiskiState(
        wty=wty,
        ydy=state.ydy + torch.sum(y * dinv_y, dim=-2),
        roots=roots,
        d_logdet=state.d_logdet + torch.sum(torch.log(noise), dim=-2),
        num_data=state.num_data + w_cols.shape[-1],
    )


@spanned("wiski_stream")
def wiski_stream(
    model: WiskiModel,
    state: WiskiState,
    xs: torch.Tensor,
    ys: torch.Tensor,
    noises: torch.Tensor,
    detach_interp: bool = True,
    block_size: int = 128,
) -> WiskiState:
    """Absorb a stream of n single points: one exact rank-1 root update per
    point, the same math and order as a loop of ``wiski_condition``, with
    every order-independent piece (stencils, wty, ydy, d_logdet, the Gram
    accumulator) done in bulk and the roots recursion blocked into
    rank-``block_size`` chunks (kernel K1 on CUDA, updating the roots in
    place). ``block_size <= 1`` runs the per-point loop over K2. Without
    ``detach_interp`` the same recursions run in forms autograd takes
    (:func:`~online_gp_torch.ops.root_update.blocked_chunk_stacked`, the
    plain rank-1 update), never a kernel.

    Args:
      xs: (n, D); ys, noises: (n, B) (reshaped, not broadcast).
    """
    _refuse_grid_sharded(state, "wiski_stream", "sharded_stream_blocked")
    B = model.num_outputs
    m = model.grid.num_points
    n = xs.shape[0]
    y = ys.reshape(n, B)
    noise = noises.reshape(n, B)
    idx, w = interp_coeffs(model.grid, xs, detach=detach_interp)

    with f32_matmul_precision():
        dinv_y = y / noise
        wty = state.wty + wt_matvec(idx, w, dinv_y, m).T[..., None]
        ydy = state.ydy + torch.sum(y * dinv_y, dim=0)
        d_logdet = state.d_logdet + torch.sum(torch.log(noise), dim=0)
        if state.roots.mat is None:
            new_mat = None
        else:
            # Gram accumulator A += W D^{-1} W^T in bounded 2048-point segments
            ninv = 1.0 / torch.clamp(noise, min=1e-7)
            new_mat = state.roots.mat
            for s in range(0, n, 2048):
                wt_s = dense_w(idx[s : s + 2048], w[s : s + 2048], m)  # (m, seg)
                new_mat = new_mat + torch.einsum(
                    "bmc,kc->bmk", wt_s[None] * ninv[s : s + 2048].T[:, None, :], wt_s
                )

    rn = torch.sqrt(torch.clamp(noise, min=1e-7))  # (n, B)
    if block_size > 1:
        wv = w[None, :, :] / rn.T[:, :, None]  # (B, n, P)
        root, inv_root = roots_stream_blocked_batched(
            state.roots.root, state.roots.inv_root, idx, wv, block=block_size, differentiable=not detach_interp
        )
    else:
        apply = rank1_apply if detach_interp else roots_apply_rank1_p
        root, inv_root = state.roots.root, state.roots.inv_root
        for i in range(n):
            with f32_matmul_precision():
                p = torch.einsum("p,bpm->bm", w[i], inv_root[:, idx[i], :]) / rn[i][:, None]
            root, inv_root = apply(root.contiguous(), inv_root.contiguous(), p.contiguous())

    return WiskiState(
        wty=wty,
        ydy=ydy,
        roots=RootCache(mat=new_mat, root=root, inv_root=inv_root),
        d_logdet=d_logdet,
        num_data=state.num_data + n,
    )


def wiski_slim(state: WiskiState) -> WiskiState:
    """Drop the exact Gram accumulator: the rank-1 updates then touch only
    the two maintained roots."""
    return state._replace(roots=root_cache_slim(state.roots))


def wiski_unslim(state: WiskiState) -> WiskiState:
    """Rebuild the Gram accumulator (A = L L^T) for a slim state."""
    return state._replace(roots=root_cache_rebuild_mat(state.roots))


def wiski_refresh_roots(state: WiskiState, jitter: float = 1e-4) -> WiskiState:
    """Recompute the roots from the Gram accumulator (from L L^T on a slim
    state, which stays slim); bounds f32 root drift over long streams."""
    slim = state.roots.mat is None
    roots = root_cache_init(root_cache_rebuild_mat(state.roots).mat, jitter=jitter)
    if slim:
        roots = root_cache_slim(roots)
    return state._replace(roots=roots)


def wiski_check_decomposition(state: WiskiState) -> Dict[str, torch.Tensor]:
    """Decomposition health per output: ||L L^T - A||_max / ||A||_max and
    ||L B^T - I||_max. On slim states the first has no anchor and is NaN."""
    L, B, A = state.roots.root, state.roots.inv_root, state.roots.mat
    with f32_matmul_precision():
        ident = L @ B.mT
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    inv_err = torch.amax(torch.abs(ident - eye), dim=(-2, -1))
    if A is None:
        return {
            "root_recon_rel_err": torch.full_like(inv_err, float("nan")),
            "inverse_root_err": inv_err,
        }
    with f32_matmul_precision():
        recon = L @ L.mT
    recon_err = torch.amax(torch.abs(recon - A), dim=(-2, -1)) / torch.clamp(
        torch.amax(torch.abs(A), dim=(-2, -1)), min=1e-12
    )
    return {"root_recon_rel_err": recon_err, "inverse_root_err": inv_err}


# ---------------------------------------------------------------------------
# Woodbury MLL
# ---------------------------------------------------------------------------


def _kuu_eff(model: WiskiModel, params: Dict, like: torch.Tensor) -> torch.Tensor:
    """K_uu, divided by the learnable second noise when present, promoted to
    the dtype of the state tensor ``like`` (the JAX package's matmul
    promotion: float32 params against float64 caches compute in float64)."""
    Kuu = grid_kuu_dense(model.kernel, params["kernel"], model.grid)  # (B, m, m)
    s2 = _second_noise(model, params)
    if s2 is not None:
        Kuu = Kuu / s2[..., None, None]
    return Kuu.to(torch.promote_types(Kuu.dtype, like.dtype))


def _dense_inner_pieces(E, L, wty):
    """Dense Woodbury inner core, batched over outputs:

      Q = I + L^T E L,  proj = L^T E wty,  sol = Q^{-1} proj
      inner_qform = proj^T sol, inner_logdet = log|Q|, Kuu_wty = E wty
    """
    with f32_matmul_precision():
        EL = E @ L
        eye = torch.eye(EL.shape[-1], dtype=EL.dtype, device=EL.device)
        Lq = spd_cholesky(eye + L.mT @ EL)  # Q = I + PSD: well conditioned, no jitter
        Kw = E @ wty
        proj = L.mT @ Kw
        sol = cho_solve(Lq, proj)
        qf = torch.sum(proj * sol, dim=(-2, -1))
        ld = chol_logdet(Lq)
    return qf, ld, Kw, Lq, sol


class _DenseInnerCore(torch.autograd.Function):
    """(inner_qform, inner_logdet, Kuu_wty) of :func:`_dense_inner_pieces`
    with a CLOSED-FORM backward (``_dense_inner_core`` of the JAX package).

    Autodiff through the Cholesky of Q costs several times the forward (on
    an H100 at m = 900, 5.5x this backward: PERF.md). The matrix-calculus
    gradients need only what the forward has, with u = L sol and w = wty:

      d inner_qform = tr(dE (w u^T + u w^T - u u^T))
      d log|Q|      = tr(dE (L Q^{-1} L^T)),  L Q^{-1} L^T = W^T W,
                      W = Lq^{-1} L^T (one m-RHS triangular solve, a syrk)

    The state's cotangents (L_bar, w_bar; L_bar with a second solve
    S = Lq^{-T} W) are formed only where ``ctx.needs_input_grad`` asks for
    them: the hyper step holds the state constant, ``fit`` differentiates
    through ``wiski_init``. Inside ``forward`` grad mode is off, so Q needs
    no grad and kernel K6 factors it on the card. The backward runs at true
    float32 (TF32 off) or float64.
    """

    @staticmethod
    def forward(ctx, E, L, wty):
        qf, ld, Kw, Lq, sol = _dense_inner_pieces(E, L, wty)
        ctx.save_for_backward(E, L, wty, Kw, Lq, sol)
        return qf, ld, Kw

    @staticmethod
    def backward(ctx, cq, cl, cKw):
        E, L, wty, Kw, Lq, sol = ctx.saved_tensors
        need_E, need_L, need_w = ctx.needs_input_grad
        cq_, cl_ = cq[:, None, None], cl[:, None, None]
        E_bar = L_bar = w_bar = None
        with f32_matmul_precision():
            u = L @ sol  # (B, m, 1)
            if need_E or need_L:
                W = tri_solve(Lq, L.mT)  # (B, m, m)
            if need_E:
                G = W.mT @ W  # L Q^{-1} L^T
                wuT = wty @ u.mT
                E_bar = (
                    cq_ * (wuT + wuT.mT - u @ u.mT)
                    + cl_ * G
                    + 0.5 * (cKw @ wty.mT + wty @ cKw.mT)
                )
            if need_L or need_w:
                Eu = E @ u
            if need_L:
                S = tri_solve(Lq, W, trans=True)  # Q^{-1} L^T
                L_bar = cq_ * 2.0 * ((Kw - Eu) @ sol.mT) + cl_ * 2.0 * (E @ S.mT)
            if need_w:
                w_bar = cq_ * 2.0 * Eu + E @ cKw
        return E_bar, L_bar, w_bar


NUM_PROBES = 32  # SLQ and Hutchinson probes per output (the JAX package's)


class MllProbes(NamedTuple):
    """Rademacher probes of the iterative MLL, per output: ``slq`` (B, P, m)
    start vectors of the SLQ Lanczos runs, ``hutch`` (B, m, P) the
    Hutchinson trace probes of the log|Q| gradient."""

    slq: torch.Tensor
    hutch: torch.Tensor


def mll_probes(
    num_outputs: int,
    m: int,
    generator: torch.Generator,
    dtype=torch.float32,
    device=None,
    num_probes: int = NUM_PROBES,
) -> MllProbes:
    """Draw :class:`MllProbes` from ``generator`` (on its own device), then
    move them to ``device``. A CPU generator gives the same probes to a run
    on the card and to its CPU twin."""
    slq = rademacher((num_outputs, num_probes, m), generator, dtype)
    hutch = rademacher((num_outputs, m, num_probes), generator, dtype)
    return MllProbes(slq.to(device), hutch.to(device))


def _kuu_mvm_fn(model: WiskiModel, params: Dict, use_toeplitz: bool, like: torch.Tensor) -> Callable:
    """x (B, m, k) -> K_uu x / s2 in x's dtype: Toeplitz-FFT products, or a
    dense K_uu (promoted to the dtype of ``like``) under a matmul."""
    s2 = _second_noise(model, params)
    if use_toeplitz:
        kuu = grid_kuu_operator(model.kernel, params["kernel"], model.grid, use_toeplitz=True)
        return kuu if s2 is None else (lambda x: kuu(x) / s2[:, None, None])
    Kuu = _kuu_eff(model, params, like)
    return lambda x: Kuu @ x


def _mll_inner_iterative(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    cfg: SolverConfig,
    probes: MllProbes,
):
    """CG/SLQ inner MLL terms for m > max_cholesky_size (the JAX package's
    ``_mll_inner_iterative``), batched over the outputs:

      inner_qform  = proj^T Q^{-1} proj     batched CG, differentiated
                                            through its iterations
      inner_logdet = log|Q|                 SLQ value; its gradient from the
                     Hutchinson surrogate sg(Q^{-1} z)^T Q z / P, exact in
                     expectation: d log|Q| = tr(Q^{-1} dQ)
      Kuu_wty      = K_uu (W D^{-1} y) / s2 via the structured MVM

    The SLQ run and the Hutchinson solve need no gradient and run under
    ``torch.no_grad()``.
    """
    m = state.roots.root.shape[-1]
    cg_iters = min(cfg.max_cg_iterations, m)
    slq_iters = min(cfg.max_root_decomposition_size, m, 64)
    L, wty = state.roots.root, state.wty
    kuu_mvm = _kuu_mvm_fn(model, params, cfg.use_toeplitz, wty)

    def q_mvm(v):
        return v + L.mT @ kuu_mvm(L @ v)

    num_probes = probes.hutch.shape[-1]
    with f32_matmul_precision():
        kuu_wty = kuu_mvm(wty)  # (B, m, 1)
        proj = L.mT @ kuu_wty
        sol = batched_cg(q_mvm, proj, max_iters=cg_iters, tol=cfg.cg_tolerance)
        qform = torch.sum(proj * sol, dim=(-2, -1))
        with torch.no_grad():
            slq_val = slq_logdet(lambda v: q_mvm(v.mT).mT, probes.slq.to(L.dtype), num_iters=slq_iters)
            z = probes.hutch.to(L.dtype)
            qinv_z = batched_cg(q_mvm, z, max_iters=cg_iters, tol=cfg.cg_tolerance)
        surrogate = torch.sum(qinv_z * q_mvm(z), dim=(-2, -1)) / num_probes
        logdet = (slq_val - surrogate).detach() + surrogate
    return qform, logdet, kuu_wty


def wiski_mll(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    cfg: SolverConfig = DEFAULT_CONFIG,
    *,
    probes: Optional[MllProbes] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Exact GP marginal log-likelihood from the caches alone, per output:

      quad   = [y'D^{-1}y - (WD^{-1}y)' K (WD^{-1}y) + proj' Q^{-1} proj] / s2
      logdet = log|Q| + log|D| (+ n log s2)
      mll    = -(quad + logdet + n log 2pi)/2 + log p(theta);   returned / n

    At m <= cfg.max_cholesky_size the inner terms go through
    :class:`_DenseInnerCore` (closed-form backward); above it through
    :func:`_mll_inner_iterative`, whose probes are ``probes``, or are drawn
    from ``generator``, or else from a CPU generator seeded 0 (the JAX
    package's ``slq_key=None`` is its PRNGKey(0)). Under
    ``cfg.grid_shard_axis`` the state is row-sharded over that mesh axis
    and the inner terms come from
    :func:`online_gp_torch.parallel.grid.grid_mll_inner` (autograd through
    the pieces, as the JAX package's sharded branch; above
    ``max_cholesky_size`` CG/SLQ on the same probes, drawn alike on every
    rank). Returns (B,).
    """
    m = state.roots.root.shape[-1]
    if m > cfg.max_cholesky_size and probes is None:
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        probes = mll_probes(model.num_outputs, m, gen, state.wty.dtype, state.wty.device)
    if _grid_axis(state, cfg) is not None:
        from online_gp_torch.parallel.grid import grid_mll_inner

        inner_qform, inner_logdet, inducing_qform = grid_mll_inner(model, params, state, cfg, probes)
    else:
        if m > cfg.max_cholesky_size:
            inner_qform, inner_logdet, Kuu_wty = _mll_inner_iterative(model, params, state, cfg, probes)
        else:
            inner_qform, inner_logdet, Kuu_wty = _DenseInnerCore.apply(
                _kuu_eff(model, params, state.wty), state.roots.root, state.wty
            )
        inducing_qform = torch.sum(state.wty * Kuu_wty, dim=(-2, -1))
    if cfg.skip_logdet_forward:
        # zero in the forward value, gradient intact
        inner_logdet = inner_logdet - inner_logdet.detach()

    quad = state.ydy - inducing_qform + inner_qform
    logdet = inner_logdet + state.d_logdet
    n = float(state.num_data)
    final = torch.full_like(quad, n * LOG_2PI)
    s2 = _second_noise(model, params)
    if s2 is not None:
        quad = quad / s2
        final = final + n * torch.log(s2)
    res = -0.5 * (quad + logdet + final)
    if model.priors:
        res = res + log_prior_sum(dict(model.priors), params["kernel"], model.kernel.transforms)
    return res / n


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------


def _q_factor(model: WiskiModel, params: Dict, state: WiskiState):
    """Kuu_eff, Kuu L, chol(Q), Kuu W D^{-1} y and proj = L^T Kuu W D^{-1} y,
    with TF32 off (Q's conditioning scales with num_data). Q is factored by
    :func:`spd_cholesky`: kernel K6 on the card when built without grad."""
    with f32_matmul_precision():
        Kuu = _kuu_eff(model, params, state.wty)
        L = state.roots.root
        KuuL = Kuu @ L
        eye = torch.eye(KuuL.shape[-1], dtype=KuuL.dtype, device=KuuL.device)
        Lq = spd_cholesky(eye + L.mT @ KuuL)
        Kuu_wty = Kuu @ state.wty
        proj = L.mT @ Kuu_wty
    return Kuu, KuuL, Lq, Kuu_wty, proj


@spanned("wiski_prediction_caches")
def wiski_prediction_caches(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Grid-space predictive caches, exact path:

      mean_cache = K W D^{-1} y - (K L) Q^{-1} (L' K W D^{-1} y)   (B, m, 1)
      cov_cache  = K - (K L) Q^{-1} (K L)'                         (B, m, m)

    with K = Kuu / s2; under ``fast_pred_var`` below full rank the LOVE
    root's cov_cache. Under ``cfg.grid_shard_axis``, both row-sharded
    like the state (:func:`online_gp_torch.parallel.grid.grid_prediction_caches`).
    """
    if _grid_axis(state, cfg) is not None:
        from online_gp_torch.parallel.grid import grid_prediction_caches

        return grid_prediction_caches(model, params, state, cfg)
    Kuu, KuuL, Lq, Kuu_wty, proj = _q_factor(model, params, state)
    m = KuuL.shape[-1]
    k = min(m, cfg.max_root_decomposition_size)
    with f32_matmul_precision():
        mean_cache = Kuu_wty - KuuL @ cho_solve(Lq, proj)
        if cfg.skip_posterior_variances:
            return mean_cache, None
        if cfg.fast_pred_var and k < m:
            # LOVE: a rank-k Lanczos inverse root Rq of Q (Q^{-1} ~= Rq Rq^T),
            # started from proj, so cov ~= Kuu - (KuuL Rq)(KuuL Rq)^T
            L = state.roots.root
            kuu_mvm = _kuu_mvm_fn(model, params, cfg.use_toeplitz, state.wty)
            Qlan, alphas, betas = lanczos(
                lambda v: v + (L.mT @ kuu_mvm(L @ v[..., None]))[..., 0], proj[..., 0], k
            )
            T = torch.diag_embed(alphas) + torch.diag_embed(betas, offset=1) + torch.diag_embed(betas, offset=-1)
            evals, evecs = torch.linalg.eigh(T)
            evals = torch.clamp(evals, min=1e-10)
            R = KuuL @ (Qlan.mT @ (evecs / torch.sqrt(evals)[..., None, :]))  # (B, m, k)
            return mean_cache, Kuu - R @ R.mT
        # the exact path: R = Lq^{-1} (KuuL)^T is the same root at full rank
        R = tri_solve(Lq, KuuL.mT)  # (B, m, m)
        cov_cache = Kuu - R.mT @ R
    return mean_cache, cov_cache


def wiski_predict(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    x: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG,
    caches: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Posterior f-moments at test points: mean (B, n), var (B, n) or None.
    The second noise rescales the variance; observation noise is not
    added. Under ``cfg.grid_shard_axis`` the moments come from each rank's
    rows of the caches and one all_reduce
    (:func:`online_gp_torch.parallel.grid.grid_predict`)."""
    if _grid_axis(state, cfg) is not None:
        from online_gp_torch.parallel.grid import grid_predict

        return grid_predict(model, params, state, x, cfg, caches)
    if caches is None:
        caches = wiski_prediction_caches(model, params, state, cfg)
    mean_cache, cov_cache = caches
    if cfg.fast_pred_samples and cov_cache is not None:
        # the variance is the row norm of the interpolated covariance root
        # that joint sampling uses (rank-capped by max_root_decomposition_size)
        mean, root = wiski_predict_root(model, params, state, x, cfg, caches=caches)
        return mean, torch.clamp(torch.sum(root * root, dim=-1), min=1e-12)
    idx, w = interp_coeffs(model.grid, x, detach=cfg.detach_interp_coeff)
    mean, var = gather_predict(idx, w, mean_cache, cov_cache)
    if var is not None:
        s2 = _second_noise(model, params)
        if s2 is not None:
            var = var * s2[..., None]
        var = torch.clamp(var, min=1e-12)
    return mean, var


def root_start_vector(m: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The Lanczos start vector of :func:`wiski_predict_root` below full
    rank: m standard normals from a CPU generator seeded 0, so that a run
    on the card and its CPU twin start from the same vector (the JAX
    package draws its own from PRNGKey(0))."""
    return torch.randn(m, generator=torch.Generator().manual_seed(0), dtype=torch.float64).to(dtype=dtype, device=device)


def wiski_grid_root(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    cfg: SolverConfig = DEFAULT_CONFIG,
    caches: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
) -> torch.Tensor:
    """The grid-space root (B, m, k) of cov_cache that
    :func:`wiski_predict_root` interpolates: a jittered Cholesky factor at
    m <= cfg.max_root_decomposition_size, else a rank-capped Lanczos root
    started from :func:`root_start_vector`. It does not depend on the query
    points, so an acquisition optimization builds it once and hands it to
    every call. Under ``cfg.grid_shard_axis``, the root row-sharded like
    the state (:func:`online_gp_torch.parallel.grid.grid_grid_root`)."""
    if _grid_axis(state, cfg) is not None:
        from online_gp_torch.parallel.grid import grid_grid_root

        return grid_grid_root(model, params, state, cfg, caches)
    if caches is None:
        caches = wiski_prediction_caches(model, params, state, cfg)
    cov_cache = caches[1]
    if cov_cache is None:
        raise ValueError(
            "wiski_predict_root needs the covariance cache: unset skip_posterior_variances "
            "(mean-only configs have no root)"
        )
    m = cov_cache.shape[-1]
    k = min(m, cfg.max_root_decomposition_size)
    if k < m:
        v0 = root_start_vector(m, cov_cache.dtype, cov_cache.device)
        with f32_matmul_precision():
            return lanczos_root(
                lambda v: (cov_cache @ v[..., None])[..., 0], v0.expand(cov_cache.shape[:-1]), k
            )  # (B, m, k)
    return psd_safe_cholesky(cov_cache, jitter=cfg.cholesky_jitter, tries=cfg.max_cholesky_jitter_tries)


def wiski_predict_root(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    x: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG,
    caches: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    grid_root: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``fast_pred_samples`` path: the mean and a low-rank root
    W_x @ root(cov_cache) of the joint posterior covariance, for sampling.

    The grid-space root is ``grid_root`` when given, else
    :func:`wiski_grid_root` of the caches.

    Returns mean (B, n) and root (B, n, k) with cov ~= root @ root^T,
    k = min(m, cfg.max_root_decomposition_size). Under
    ``cfg.grid_shard_axis``, from each rank's rows and one all_reduce
    (:func:`online_gp_torch.parallel.grid.grid_predict_root`).
    """
    if _grid_axis(state, cfg) is not None:
        from online_gp_torch.parallel.grid import grid_predict_root

        return grid_predict_root(model, params, state, x, cfg, caches, grid_root)
    if caches is None:
        caches = wiski_prediction_caches(model, params, state, cfg)
    if grid_root is None:
        grid_root = wiski_grid_root(model, params, state, cfg, caches)
    idx, w = interp_coeffs(model.grid, x, detach=cfg.detach_interp_coeff)
    mean = interp_matvec(idx, w, caches[0])[..., 0]
    root = interp_matvec(idx, w, grid_root)  # (B, n, k)
    s2 = _second_noise(model, params)
    if s2 is not None:
        root = root * torch.sqrt(s2)[..., None, None]
    return mean, root


@spanned("wiski_pred_cache_condition")
def wiski_pred_cache_condition(
    model: WiskiModel,
    caches: Tuple[torch.Tensor, torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    detach_interp: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact O(m^2 q) conditioning of the grid-space predictive caches on q
    new observations (the second noise cancels):

        beta = diag(noise) + W^T C W            (q, q)
        mu'  = mu + C W beta^{-1} (y - W^T mu)
        C'   = C  - C W beta^{-1} (C W)^T

    Args:
      caches: (mean_cache (B, m, 1), cov_cache (B, m, m)).
      x: (q, D); y, noise: (q, B).
    """
    mean_cache, cov_cache = caches
    if cov_cache is None:
        raise ValueError(
            "pred-cache conditioning needs cov_cache (built without skip_posterior_variances)"
        )
    B = model.num_outputs
    m = model.grid.num_points
    y, noise = _reshape_obs(y, noise, B)
    noise = torch.clamp(noise, min=1e-7)
    idx, w = interp_coeffs(model.grid, x, detach=detach_interp)
    w_cols = dense_w(idx, w, m)  # (m, q)
    with f32_matmul_precision():
        cw = cov_cache @ w_cols  # (B, m, q)
        beta = w_cols.mT @ cw + torch.diag_embed(noise.T)  # (B, q, q)
        Lb = psd_safe_cholesky(beta, jitter=1e-8)
        resid = y.T[:, :, None] - w_cols.mT @ mean_cache  # (B, q, 1)
        new_mean = mean_cache + cw @ cho_solve(Lb, resid)
        new_cov = cov_cache - cw @ cho_solve(Lb, cw.mT)
        new_cov = 0.5 * (new_cov + new_cov.mT)
    return new_mean, new_cov


@spanned("wiski_prequential_stream")
def wiski_prequential_stream(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    caches: Tuple[torch.Tensor, torch.Tensor],
    xs: torch.Tensor,
    ys: torch.Tensor,
    noises: torch.Tensor,
    detach_interp: bool = True,
    block_size: int = 128,
):
    """Interleaved evaluate-then-condition over a stream of n single points:
    each point is predicted from the posterior on all previous points, then
    absorbed; blocked into rank-``block_size`` chunks (kernel K3 for the
    caches, kernel K1 for the state, both in place on CUDA; without
    ``detach_interp``, their forms autograd takes). Valid while the
    hyperparameters are fixed.

    Args:
      caches: (mean_cache (B, m, 1), cov_cache (B, m, m)) from
        :func:`wiski_prediction_caches`.
      xs: (n, D); ys, noises: (n, B).

    Returns (new_state, new_caches, pred_mean (B, n), pred_var (B, n));
    the moments match :func:`wiski_predict` at the same prefix.
    """
    _refuse_grid_sharded(state, "wiski_prequential_stream", "sharded_pred_stream_blocked")
    mean_cache, cov_cache = caches
    if cov_cache is None:
        raise ValueError(
            "prequential streaming needs cov_cache (built without skip_posterior_variances)"
        )
    B = model.num_outputs
    y, noise = _reshape_obs(ys, noises, B)
    nz = torch.clamp(noise, min=1e-7)
    idx, w = interp_coeffs(model.grid, xs, detach=detach_interp)
    new_C, new_mu, pm, pv = pred_stream_blocked_batched(
        cov_cache, mean_cache[..., 0], idx, w, y.T, nz.T, block=block_size, differentiable=not detach_interp
    )
    s2 = _second_noise(model, params)
    if s2 is not None:
        pv = pv * s2[:, None]
    pv = torch.clamp(pv, min=1e-12)
    new_state = wiski_stream(
        model, state, xs, ys, noises, detach_interp=detach_interp, block_size=block_size
    )
    return new_state, (new_mu[..., None], new_C), pm, pv


# ---------------------------------------------------------------------------
# fantasy batching (q-acquisition support)
# ---------------------------------------------------------------------------


def wiski_expand(state: WiskiState, num_fantasies: int) -> WiskiState:
    """The state broadcast along a new leading fantasy dim F (views, no
    copy: nothing here writes them in place). ``num_data`` stays one int,
    shared by the fantasies, where the JAX package tiles it."""
    tile = lambda a: a.expand(num_fantasies, *a.shape)
    return WiskiState(
        wty=tile(state.wty),
        ydy=tile(state.ydy),
        roots=root_cache_expand(state.roots, (num_fantasies,)),
        d_logdet=tile(state.d_logdet),
        num_data=state.num_data,
    )


def wiski_condition_batched(
    model: WiskiModel,
    state: WiskiState,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
) -> WiskiState:
    """Condition a batch of F states (tensors with a leading F dim, e.g.
    from :func:`wiski_expand`), each on its own q points, differentiably:
    the interpolation weights keep their gradient (``detach_interp=False``)
    and the plain rank-q update runs, batched over F (where JAX vmaps
    ``wiski_condition``): no kernel, nothing in place.

    Args:
      x: (F, q, D); y, noise: (F, q, B).
    """
    F, q, D = x.shape
    B, m = model.num_outputs, model.grid.num_points
    idx, w = interp_coeffs(model.grid, x.reshape(F * q, D), detach=False)
    w_cols = dense_w(idx, w, m).reshape(m, F, q).movedim(1, 0)  # (F, m, q)
    return _condition_dense(state, w_cols, y.reshape(F, q, B), noise.reshape(F, q, B))


def wiski_fantasize(
    model: WiskiModel,
    state: WiskiState,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
) -> WiskiState:
    """Condition F independent fantasy copies of the state.

    Args:
      x: (F, q, D) fantasy inputs; y, noise: (F, q, B).

    Returns a state whose tensors carry a leading F dim; ``num_data`` bumps
    by q. Fantasies feed differentiable acquisitions, so the interpolation
    weights keep their gradient (the JAX package's ``detach_interp=False``)
    and the conditioning is :func:`wiski_condition_batched` on the expanded
    state: no kernel, nothing in place, so ``state`` is left as it was.
    """
    return wiski_condition_batched(model, wiski_expand(state, x.shape[0]), x, y, noise)
