"""Local GP experts: a kernel-routed mixture of exact GPs (port of
``online_gp_tpu/models/localgp.py``).

A pool of exact GP experts shares one covariance module. Each streamed
point goes to the expert of highest kernel weight with room left (among
the top half of the ranking); when every candidate is full a new expert
is spawned. Prediction is the kernel-weighted mixture (weights clamped at
1e-4) of the experts' Gaussian posteriors.

The experts live in one batched masked buffer (E, cap, ...), so the
experts' posteriors are one batched Cholesky, on the card as on the TPU.
Routing is small and data-dependent and runs on the host: one readback of
the weights a point.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from online_gp_torch.kernels.base import Kernel
from online_gp_torch.ops.chol import cho_solve, chol_logdet, sym_psd_safe_cholesky, tri_solve
from online_gp_torch.ops.precision import f32_matmuls

LOG_2PI = 1.8378770664093453


class LocalGPModel(NamedTuple):
    kernel: Kernel
    max_data_per_model: int = 256
    max_experts: int = 32
    jitter: float = 1e-6

    def init_params(self, num_dims: int, dtype=torch.float32, device="cuda", **kw) -> Dict:
        return {
            "kernel": self.kernel.init_params(num_dims, (), dtype=dtype, device=device, **kw),
            "raw_noise": torch.tensor(math.log(0.5), dtype=dtype, device=device),
        }


class LocalGPState(NamedTuple):
    x: torch.Tensor  # (E, cap, d)
    y: torch.Tensor  # (E, cap)
    mask: torch.Tensor  # (E, cap)
    counts: torch.Tensor  # (E,) int32
    active: torch.Tensor  # (E,) 1.0 for live experts
    centers: torch.Tensor  # (E, d) mean of each expert's inputs


def localgp_init(model: LocalGPModel, x, y, seed: int = 0, device="cuda") -> LocalGPState:
    """Split the initial data over ceil(n / cap) experts: at random
    (``np.random.default_rng(seed)``) when they do not fit one, with the
    overflow of a full expert moved to the first with room. x and y are
    host arrays; the state is float32 on ``device``."""
    x = np.asarray(x)
    y = np.asarray(y).reshape(-1)
    n, d = x.shape
    cap, E = model.max_data_per_model, model.max_experts
    rng = np.random.default_rng(seed)
    num_models = max(1, math.ceil(n / cap))
    if num_models > E:
        raise ValueError(f"init data needs {num_models} experts > max_experts={E}")
    assign = rng.integers(0, num_models, size=n) if num_models > 1 else np.zeros(n, np.int64)
    for e in range(num_models):
        idx = np.flatnonzero(assign == e)
        if len(idx) > cap:
            spill = idx[cap:]
            room = [m for m in range(num_models) if np.sum(assign == m) < cap]
            for p in spill:
                room = [m for m in room if np.sum(assign == m) < cap]
                if not room:
                    break
                assign[p] = room[0]

    xb = np.zeros((E, cap, d), np.float32)
    yb = np.zeros((E, cap), np.float32)
    mask = np.zeros((E, cap), np.float32)
    counts = np.zeros((E,), np.int32)
    centers = np.zeros((E, d), np.float32)
    active = np.zeros((E,), np.float32)
    for e in range(num_models):
        idx = np.flatnonzero(assign == e)[:cap]
        k = len(idx)
        xb[e, :k] = x[idx]
        yb[e, :k] = y[idx]
        mask[e, :k] = 1.0
        counts[e] = k
        centers[e] = x[idx].mean(axis=0) if k else 0.0
        active[e] = 1.0
    return LocalGPState(*(torch.from_numpy(a).to(device) for a in (xb, yb, mask, counts, active, centers)))


@f32_matmuls
def localgp_weights(model: LocalGPModel, params: Dict, state: LocalGPState, x: torch.Tensor) -> torch.Tensor:
    """(n, E) kernel weights to the expert centers (clamped at 1e-4, zero
    for inactive experts)."""
    w = model.kernel.matrix(params["kernel"], x, state.centers)
    return torch.clamp(w, min=1e-4) * state.active[None, :]


def localgp_route(model: LocalGPModel, params: Dict, state: LocalGPState, x_np: np.ndarray) -> int:
    """The expert for one point (host side): rank the active experts by
    weight and take the best one with room among the top ceil(E_active / 2);
    -1 asks for a new expert."""
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(x_np)[None], device=state.centers.device)
        w = localgp_weights(model, params, state, x)[0].cpu().numpy()
    counts = state.counts.cpu().numpy()
    active = state.active.cpu().numpy()
    n_active = int(active.sum())
    order = np.argsort(-w)
    candidates = [e for e in order if active[e] > 0][: math.ceil(n_active / 2)]
    for e in candidates:
        if counts[e] < model.max_data_per_model:
            return int(e)
    return -1


def localgp_add_point(state: LocalGPState, expert: int, x, y) -> LocalGPState:
    """Append one point to an expert (spawning it if inactive); a new state.

    An expert that is full (the wrappers' fallback once every expert is
    full and the pool is spent) drops the point, as the JAX package's
    out-of-bounds scatter does, while its count still grows."""
    e, c = expert, int(state.counts[expert])
    xs, ys, mask = state.x.clone(), state.y.clone(), state.mask.clone()
    if c < xs.shape[1]:
        xs[e, c], ys[e, c], mask[e, c] = x, y, 1.0
    counts, active, centers = state.counts.clone(), state.active.clone(), state.centers.clone()
    counts[e] = c + 1
    active[e] = 1.0
    centers[e] = torch.sum(xs[e] * mask[e][:, None], dim=0) / (c + 1)
    return LocalGPState(xs, ys, mask, counts, active, centers)


def _lifted(t: torch.Tensor, scalar: torch.Tensor) -> torch.Tensor:
    """t in the dtype JAX promotes it to against a 0-dim param: torch keeps a
    dimensioned tensor's dtype against a 0-dim one, so float64 params would
    meet the float32 buffers in float32."""
    return t.to(torch.promote_types(t.dtype, scalar.dtype))


def _expert_chol(model: LocalGPModel, params: Dict, state: LocalGPState) -> torch.Tensor:
    K = torch.func.vmap(lambda xe: model.kernel.matrix(params["kernel"], xe, xe))(state.x)
    mm = state.mask[:, :, None] * state.mask[:, None, :]
    noise = torch.exp(params["raw_noise"])
    mask = _lifted(state.mask, noise)
    eye = torch.eye(state.x.shape[1], dtype=K.dtype, device=K.device)
    diag = noise * mask + (1.0 - mask)
    return sym_psd_safe_cholesky(K * mm + diag[:, :, None] * eye, jitter=model.jitter)


@f32_matmuls
def localgp_joint_mll(model: LocalGPModel, params: Dict, state: LocalGPState) -> torch.Tensor:
    """Sum over the active experts of their exact MLL / n_e (the reference's
    ``SumMarginalLogLikelihood`` objective)."""
    L = _expert_chol(model, params, state)
    alpha = tri_solve(L, (state.y * state.mask)[:, :, None])
    quad = torch.sum(alpha * alpha, dim=(-2, -1))
    counts = state.counts.to(quad.dtype)
    per_expert = -0.5 * (quad + chol_logdet(L) + counts * LOG_2PI) / torch.clamp(counts, min=1.0)
    return torch.sum(per_expert * state.active)


@f32_matmuls
def localgp_expert_moments(
    model: LocalGPModel, params: Dict, state: LocalGPState, xt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each expert's share of the mixture at xt: the kernel weights (not
    normalized), the posterior means and the predictive variances, each
    (n, E)."""
    L = _expert_chol(model, params, state)
    alpha = cho_solve(L, (state.y * state.mask)[:, :, None])
    Kxt = torch.func.vmap(lambda xe: model.kernel.matrix(params["kernel"], xt, xe))(state.x)
    Kxt = Kxt * state.mask[:, None, :]
    means = (Kxt @ alpha)[..., 0]
    v = tri_solve(L, Kxt.mT)
    scale = model.kernel.outputscale(params["kernel"])
    kdiag = scale * _lifted(torch.ones((1, xt.shape[0]), dtype=xt.dtype, device=xt.device), scale)
    fvar = torch.clamp(kdiag - torch.sum(v * v, dim=-2), min=1e-12)
    yvar = fvar + torch.exp(params["raw_noise"])
    return localgp_weights(model, params, state, xt), means.T, yvar.T


def localgp_predict(
    model: LocalGPModel, params: Dict, state: LocalGPState, xt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The mixture posterior: mean (n,), variance (n,) and the per-expert
    statistics (weights, means, variances, each (n, E)) for
    :func:`localgp_log_prob`. The mixture weights are the normalized kernel
    weights."""
    w, means, yvar = localgp_expert_moments(model, params, state, xt)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    mix_mean = torch.sum(w * means, dim=-1)
    mix_var = torch.sum(w * (yvar + means**2), dim=-1) - mix_mean**2
    return mix_mean, torch.clamp(mix_var, min=1e-12), (w, means, yvar)


def localgp_log_prob(stats, y: torch.Tensor) -> torch.Tensor:
    """The mixture's exact log-density at y (n,), for the NLL."""
    w, means, variances = stats
    logp = -0.5 * (LOG_2PI + torch.log(variances) + (y[:, None] - means) ** 2 / variances)
    return torch.logsumexp(logp + torch.log(w + 1e-30), dim=-1)
