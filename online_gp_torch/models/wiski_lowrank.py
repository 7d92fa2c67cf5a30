"""Large-grid WISKI with rank-capped roots and structured K_uu products
(port of ``online_gp_tpu/models/wiski_lowrank.py``).

The dense core keeps m x m roots, which caps the grid at a few thousand
inducing points. Here the root is m x k_buf with k_buf << m, the regime
of the reference's ``max_root_decomposition_size`` (512) and
``use_toeplitz``:

  state:   root L (..., m, k_buf) with ``used`` active columns; wty, ydy,
           d_logdet as in the dense core; ``used`` and ``num_data`` are
           Python ints, shared by every output.
  update:  exact rank-q append A + v v^T = [L v][L v]^T into the spare
           buffer columns, with a top-``rank`` compression (an ``eigh`` of
           a k_buf x k_buf Gram) when the buffer is full.
  mll:     Q = I_k + L^T K_uu L through k_buf structured K_uu products (never
           a dense K_uu), then a k x k Cholesky:
             quad   = y'D^{-1}y - wty' K wty + proj' Q^{-1} proj,
             logdet = log|Q| + log|D|,   proj = L^T K wty
  predict: mean cache K wty - (K L) Q^{-1} proj, variance through the
           rank-k root R = (K L) Lq^{-T} and one more K_uu product.

The single-output functions take states without a batch dim; the ``*_b``
variants take a leading output dim on the state and the params, over
inputs that all outputs share, and run every output in one batch. No
function here launches a hand-written kernel: the JAX package calls no
Pallas kernel on this path either, and the k x k Q goes through
``psd_safe_cholesky``, the ``eigh`` of the compression through
``torch.linalg.eigh``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel
from online_gp_torch.kernels.grid_kernel import grid_kuu_mvm
from online_gp_torch.kernels.priors import log_prior_sum
from online_gp_torch.ops.chol import cho_solve, chol_logdet, psd_safe_cholesky, tri_solve
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import dense_w, interp_coeffs, interp_matvec
from online_gp_torch.ops.precision import f32_matmul_precision

LOG_2PI = 1.8378770664093453

# Floor on the learnable second noise: skip-logdet hyper steps over a long
# stream can drive sigma^2 toward zero; the floor keeps the likelihood's
# scale sane and leaves the gradient alive above it.
S2_FLOOR = 1e-4


class WiskiLowRankModel(NamedTuple):
    kernel: Kernel
    grid: Grid
    rank: int = 512  # compression target (the reference's max_root_decomposition_size)
    buffer_cols: int = 0  # root buffer width; 0 -> 2 * rank
    learn_additional_noise: bool = False
    use_toeplitz: bool = True
    priors: Optional[tuple] = None

    @property
    def k_buf(self) -> int:
        return self.buffer_cols or 2 * self.rank

    def init_params(self, num_dims: int, dtype=torch.float32, device=None, **kw) -> Dict:
        """Single-output params, on the grid's device unless ``device`` is given."""
        device = self.grid.device if device is None else device
        params = {"kernel": self.kernel.init_params(num_dims, (), dtype=dtype, device=device, **kw)}
        if self.learn_additional_noise:
            params["raw_second_noise"] = torch.zeros((), dtype=dtype, device=device)
        return params


class WiskiLowRankState(NamedTuple):
    wty: torch.Tensor  # (..., m, 1)
    ydy: torch.Tensor  # (...,)
    root: torch.Tensor  # (..., m, k_buf); columns >= used are zero
    used: int  # active root columns
    d_logdet: torch.Tensor  # (...,)
    num_data: int


def lowrank_second_noise(params: Dict) -> Optional[torch.Tensor]:
    """Floored second noise sigma^2 = S2_FLOOR + exp(raw)."""
    raw = params.get("raw_second_noise")
    if raw is None:
        return None
    return S2_FLOOR + torch.exp(raw)


def _kuu_mvm(model: WiskiLowRankModel, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(..., m, k) -> (..., m, k) structured K_uu product (never dense)."""
    kuu = grid_kuu_mvm(model.kernel, params["kernel"], model.grid, x, model.use_toeplitz)
    s2 = lowrank_second_noise(params)
    if s2 is not None:
        kuu = kuu / s2[..., None, None]
    return kuu


def _empty_state(model: WiskiLowRankModel, bshape, dtype, device) -> WiskiLowRankState:
    m = model.grid.num_points
    f = dict(dtype=dtype, device=device)
    return WiskiLowRankState(
        wty=torch.zeros(bshape + (m, 1), **f),
        ydy=torch.zeros(bshape, **f),
        root=torch.zeros(bshape + (m, model.k_buf), **f),
        used=0,
        d_logdet=torch.zeros(bshape, **f),
        num_data=0,
    )


def _init(model, x, yT, noiseT, chunk, params) -> WiskiLowRankState:
    """Absorb the seed data through the append-then-compress recursion;
    yT and noiseT are (..., n)."""
    if model.k_buf <= model.rank:
        raise ValueError(
            f"buffer_cols ({model.k_buf}) must exceed rank ({model.rank}): the buffer needs "
            "headroom past the compression target to absorb data"
        )
    state = _empty_state(model, tuple(yT.shape[:-1]), x.dtype, x.device)
    step = min(chunk, model.k_buf - model.rank)
    for start in range(0, x.shape[0], step):
        rows = slice(start, start + step)
        state = _condition(model, state, x[rows], yT[..., rows], noiseT[..., rows], params)
    return state


def _condition(model, state, x, yT, noiseT, params) -> WiskiLowRankState:
    """Rank-q conditioning by column append; yT and noiseT are (..., q)."""
    q = x.shape[0]
    m = model.grid.num_points
    k_buf, k0 = model.k_buf, model.rank
    if q > k_buf - k0:
        raise ValueError(f"batch q={q} exceeds buffer headroom {k_buf - k0}")
    idx, w = interp_coeffs(model.grid, x, detach=True)
    w_cols = dense_w(idx, w, m)  # (m, q)
    v = w_cols / torch.sqrt(torch.clamp(noiseT, min=1e-7))[..., None, :]  # (..., m, q)

    with f32_matmul_precision():
        root, used = state.root, state.used
        if used + q > k_buf:
            # compress to the best rank-k0 approximation: of A = L L^T, or
            # with params of the whitened K^{1/2} A K^{1/2} (right-singular
            # vectors of K^{1/2} L, through k_buf structured K_uu products)
            if params is None:
                gram = root.mT @ root
            else:
                with torch.no_grad():
                    kroot = _kuu_mvm(model, params, root)
                gram = root.mT @ kroot
                gram = 0.5 * (gram + gram.mT)
            _, V = torch.linalg.eigh(gram)  # ascending
            newL = root @ V[..., :, k_buf - k0 :]
            root = torch.zeros_like(root)
            root[..., :, :k0] = newL
            used = k0
        else:
            root = root.clone()
        root[..., :, used : used + q] = v
        dinv_y = yT / noiseT  # (..., q)
        contrib = (w * dinv_y[..., :, None]).reshape(*dinv_y.shape[:-1], -1)
        new_wty = state.wty[..., 0].index_add(-1, idx.reshape(-1), contrib)[..., None]

    return WiskiLowRankState(
        wty=new_wty,
        ydy=state.ydy + torch.sum(yT * dinv_y, dim=-1),
        root=root,
        used=used + q,
        d_logdet=state.d_logdet + torch.sum(torch.log(noiseT), dim=-1),
        num_data=state.num_data + q,
    )


def wiski_lowrank_init(
    model: WiskiLowRankModel,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    chunk: int = 4096,
    params: Optional[Dict] = None,
) -> WiskiLowRankState:
    """Build the caches by absorbing the seed data through the exact
    append-then-compress recursion the stream uses, in chunks of at most
    k_buf - rank columns of V = W^T D^{-1/2}. Up to k_buf points the root is
    exact; beyond, it is the truncation a streamed ingest would give. With
    ``params`` any compression is kernel-aware (see
    :func:`wiski_lowrank_condition`). The JAX package's ``key`` argument is
    unused there and is dropped here.
    """
    return _init(model, x, y.reshape(-1), noise.reshape(-1), chunk, params)


def wiski_lowrank_condition(
    model: WiskiLowRankModel,
    state: WiskiLowRankState,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    params: Optional[Dict] = None,
) -> WiskiLowRankState:
    """Exact O(m q) rank-q conditioning by column append, with amortised
    top-``rank`` compression when fewer than q buffer slots remain (an
    ``eigh`` of a k_buf x k_buf Gram). The compression is the only
    approximation. With ``params`` it is kernel-aware: the eigh runs on
    L^T K_uu L instead of L^T L, so the retained subspace is the best
    rank-``rank`` truncation of the whitened evidence operator; the state
    then depends on the hypers at compression time, through that choice
    only, and conditioning stays gradient-free. The state passed in is
    left as it was.
    """
    return _condition(model, state, x, y.reshape(-1), noise.reshape(-1), params)


def _q_pieces(model, params, state):
    L = state.root  # (..., m, k)
    k = L.shape[-1]
    with f32_matmul_precision():
        KuuL = _kuu_mvm(model, params, L)  # (..., m, k): structured products
        Q = torch.eye(k, dtype=L.dtype, device=L.device) + L.mT @ KuuL
        Q = 0.5 * (Q + Q.mT)
        Lq = psd_safe_cholesky(Q, jitter=1e-6)
        Kuu_wty = _kuu_mvm(model, params, state.wty)  # (..., m, 1)
        proj = L.mT @ Kuu_wty  # (..., k, 1)
    return KuuL, Lq, Kuu_wty, proj


def _log_prior(model, params, batched: bool) -> torch.Tensor:
    kp, tf = params["kernel"], model.kernel.transforms
    if not batched:
        return log_prior_sum(dict(model.priors), kp, tf)
    B = next(iter(kp.values())).shape[0]
    return torch.stack([log_prior_sum(dict(model.priors), {k: v[b] for k, v in kp.items()}, tf) for b in range(B)])


def _mll(model, params, state, cfg, batched):
    _, Lq, Kuu_wty, proj = _q_pieces(model, params, state)
    with f32_matmul_precision():
        sol = cho_solve(Lq, proj)
        inner_qform = torch.sum(proj * sol, dim=(-2, -1))
        inner_logdet = chol_logdet(Lq)
        if cfg.skip_logdet_forward:
            inner_logdet = inner_logdet - inner_logdet.detach()
        inducing_qform = torch.sum(state.wty * Kuu_wty, dim=(-2, -1))
        quad = state.ydy - inducing_qform + inner_qform
        logdet = inner_logdet + state.d_logdet
        n = float(state.num_data)
        final = torch.full_like(quad, n * LOG_2PI)
        s2 = lowrank_second_noise(params)
        if s2 is not None:
            quad = quad / s2
            final = final + n * torch.log(s2)
        res = -0.5 * (quad + logdet + final)
        if model.priors:
            res = res + _log_prior(model, params, batched)
        return res / n


def wiski_lowrank_mll(
    model: WiskiLowRankModel,
    params: Dict,
    state: WiskiLowRankState,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Woodbury MLL with k x k solves and structured K_uu products; a
    scalar, divided by n."""
    return _mll(model, params, state, cfg, batched=False)


def _predict(model, params, state, x, cfg):
    KuuL, Lq, Kuu_wty, proj = _q_pieces(model, params, state)
    with f32_matmul_precision():
        mean_cache = Kuu_wty - KuuL @ cho_solve(Lq, proj)  # (..., m, 1)
        R = tri_solve(Lq, KuuL.mT).mT  # (..., m, k): KuuL Lq^{-T}
        idx, w = interp_coeffs(model.grid, x, detach=cfg.detach_interp_coeff)
        mean = interp_matvec(idx, w, mean_cache)[..., 0]  # (..., n)
        if cfg.skip_posterior_variances:
            return mean, None
        # the prior term w_x' K_uu w_x: one structured product per query batch
        m = model.grid.num_points
        Wx = dense_w(idx, w, m).expand(*state.wty.shape[:-2], m, x.shape[0])  # (..., m, n)
        prior_diag = torch.sum(Wx * _kuu_mvm(model, params, Wx), dim=-2)  # (..., n)
        Rw = interp_matvec(idx, w, R)  # (..., n, k)
        var = prior_diag - torch.sum(Rw * Rw, dim=-1)
        s2 = lowrank_second_noise(params)
        if s2 is not None:
            var = var * s2[..., None]
        return mean, torch.clamp(var, min=1e-12)


def wiski_lowrank_predict(
    model: WiskiLowRankModel,
    params: Dict,
    state: WiskiLowRankState,
    x: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Posterior mean and variance (n,) with O(m k) caches:

      mean cache  K wty - (K L) Q^{-1} proj          (m, 1)
      LOVE root   R = (K L) Lq^{-T}                  (m, k)
      var(x)    = w_x' K w_x - |R' w_x|^2 (times s2)
    """
    return _predict(model, params, state, x, cfg)


# ---------------------------------------------------------------------------
# batched (multi-output) variants: per-output params and caches over shared
# inputs, one batch for all outputs (the JAX package vmaps the functions
# above). ``used`` is shared: every output absorbs the same x.
# ---------------------------------------------------------------------------


def lowrank_init_params_batched(
    model: WiskiLowRankModel, num_dims: int, num_outputs: int, dtype=torch.float32, device=None, **kw
) -> Dict:
    """Per-output kernel hypers ((B, ...) leaves) and a (B,) second noise."""
    device = model.grid.device if device is None else device
    params = {"kernel": model.kernel.init_params(num_dims, (num_outputs,), dtype=dtype, device=device, **kw)}
    if model.learn_additional_noise:
        params["raw_second_noise"] = torch.zeros((num_outputs,), dtype=dtype, device=device)
    return params


def wiski_lowrank_init_b(
    model: WiskiLowRankModel,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    chunk: int = 4096,
    params: Optional[Dict] = None,
) -> WiskiLowRankState:
    """Batched init: shared x (n, d); y, noise (n, B). The state's tensors
    gain a leading B dim; with batched ``params`` any seed compression is
    kernel-aware per output."""
    return _init(model, x, y.T, noise.T, chunk, params)


def wiski_lowrank_condition_b(
    model: WiskiLowRankModel,
    state: WiskiLowRankState,
    x: torch.Tensor,
    y: torch.Tensor,
    noise: torch.Tensor,
    params: Optional[Dict] = None,
) -> WiskiLowRankState:
    """Batched rank-q conditioning: shared x (q, d); y, noise (q, B)."""
    return _condition(model, state, x, y.T, noise.T, params)


def wiski_lowrank_mll_b(
    model: WiskiLowRankModel,
    params: Dict,
    state: WiskiLowRankState,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """(B,) per-output MLLs; callers sum, as with the dense ``wiski_mll``."""
    return _mll(model, params, state, cfg, batched=True)


def wiski_lowrank_predict_b(
    model: WiskiLowRankModel,
    params: Dict,
    state: WiskiLowRankState,
    x: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, n) posterior means and variances at shared query points."""
    return _predict(model, params, state, x, cfg)
