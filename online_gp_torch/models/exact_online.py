"""Online exact GP, the O(n^3) baseline, on a masked buffer (port of
``online_gp_tpu/models/exact_online.py``).

The data lives in a fixed-capacity buffer with an active count, as in the
JAX package: the kernel matrix is built over the whole buffer and the
inactive rows and columns become an identity block, whose quadratic and
log-determinant terms vanish. The capacity doubles on the host when it is
full. JAX keeps the buffer to avoid retracing; the port keeps it so that
every factorization (and its jitter, scaled by the buffer's mean
diagonal) is the JAX package's.

Several outputs share the inputs and have a hyperparameter set each (B
leading on the params, botorch's batch semantics).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from online_gp_torch.kernels.base import Kernel
from online_gp_torch.kernels.priors import log_prior_sum
from online_gp_torch.ops.chol import cho_solve, chol_logdet, sym_psd_safe_cholesky, tri_solve
from online_gp_torch.ops.precision import f32_matmuls

LOG_2PI = 1.8378770664093453


class ExactGPModel(NamedTuple):
    kernel: Kernel
    num_outputs: int = 1
    learn_noise: bool = True  # False: fixed per-point noise (FixedNoiseGP)
    jitter: float = 1e-6
    # (raw_param_name, prior) pairs added into the MLL, as gpytorch's
    # registered priors
    priors: Optional[tuple] = None

    def init_params(self, num_dims: int, dtype=torch.float32, device="cuda", **kw) -> Dict:
        batch = (self.num_outputs,)
        params = {"kernel": self.kernel.init_params(num_dims, batch, dtype=dtype, device=device, **kw)}
        if self.learn_noise:
            params["raw_noise"] = torch.full(batch, math.log(0.5), dtype=dtype, device=device)
        return params


class ExactGPData(NamedTuple):
    x: torch.Tensor  # (cap, d)
    y: torch.Tensor  # (cap, B)
    noise: torch.Tensor  # (cap, B) fixed per-point noise (ones when learned)
    mask: torch.Tensor  # (cap,) 1.0 for active rows
    count: int  # active rows


def exact_data_init(x, y, noise=None, capacity: Optional[int] = None) -> ExactGPData:
    """A buffer of ``capacity`` rows (the next power of two, at least 64, by
    default) holding the n points of x (n, d), y (n, B) and noise (n, B)."""
    n, d = x.shape
    B = y.shape[-1]
    cap = capacity or max(64, 1 << (n - 1).bit_length())
    if noise is None:
        noise = torch.ones_like(y)
    xb = torch.zeros((cap, d), dtype=x.dtype, device=x.device)
    yb = torch.zeros((cap, B), dtype=y.dtype, device=y.device)
    nb = torch.ones((cap, B), dtype=y.dtype, device=y.device)
    mask = torch.zeros((cap,), dtype=x.dtype, device=x.device)
    xb[:n], yb[:n], nb[:n], mask[:n] = x, y, noise, 1.0
    return ExactGPData(xb, yb, nb, mask, n)


def exact_data_append(data: ExactGPData, x, y, noise=None) -> ExactGPData:
    """Append q points (a new buffer; the capacity doubles until they fit)."""
    q = x.shape[0]
    if noise is None:
        noise = torch.ones_like(y)
    n, cap = data.count, data.x.shape[0]
    new_cap = cap
    while new_cap < n + q:
        new_cap *= 2

    def grown(a, fill):
        out = torch.full((new_cap,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
        out[:cap] = a
        return out

    xb, yb, nb, mask = grown(data.x, 0), grown(data.y, 0), grown(data.noise, 1), grown(data.mask, 0)
    xb[n : n + q], yb[n : n + q], nb[n : n + q], mask[n : n + q] = x, y, noise, 1.0
    return ExactGPData(xb, yb, nb, mask, n + q)


def _masked_khat(model: ExactGPModel, params: Dict, data: ExactGPData) -> torch.Tensor:
    """(B, cap, cap): K + noise on the active block, identity on the rest."""
    K = model.kernel.matrix(params["kernel"], data.x, data.x)
    m = data.mask
    mm = m[:, None] * m[None, :]
    noise = data.noise.T
    if model.learn_noise:
        noise = torch.exp(params["raw_noise"])[:, None] * noise
    diag = noise * m[None, :] + (1.0 - m)[None, :]
    eye = torch.eye(data.x.shape[0], dtype=K.dtype, device=K.device)
    return K * mm[None] + diag[:, :, None] * eye


@f32_matmuls
def exact_gp_mll(model: ExactGPModel, params: Dict, data: ExactGPData) -> torch.Tensor:
    """(B,) exact MLL / n over the active rows (priors added before the
    division)."""
    L = sym_psd_safe_cholesky(_masked_khat(model, params, data), jitter=model.jitter)
    ym = (data.y * data.mask[:, None]).T[..., None]
    alpha = tri_solve(L, ym)
    quad = torch.sum(alpha * alpha, dim=(-2, -1))
    n = float(data.count)
    res = -0.5 * (quad + chol_logdet(L) + n * LOG_2PI)
    if model.priors:
        res = res + log_prior_sum(dict(model.priors), params["kernel"], model.kernel.transforms)
    return res / n


@f32_matmuls
def exact_gp_posterior(
    model: ExactGPModel, params: Dict, data: ExactGPData, xt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, t) posterior f-mean and variance at the test points xt (t, d)."""
    L = sym_psd_safe_cholesky(_masked_khat(model, params, data), jitter=model.jitter)
    Kxt = model.kernel.matrix(params["kernel"], xt, data.x) * data.mask[None, :]
    ym = (data.y * data.mask[:, None]).T[..., None]
    alpha = cho_solve(L, ym)
    mean = (Kxt @ alpha)[..., 0]
    v = tri_solve(L, Kxt.mT)
    kdiag = model.kernel.outputscale(params["kernel"])[:, None] * torch.ones(
        (1, xt.shape[0]), dtype=xt.dtype, device=xt.device)
    var = kdiag - torch.sum(v * v, dim=-2)
    return mean, torch.clamp(var, min=1e-12)


def exact_gp_observation_variance(model: ExactGPModel, params: Dict, var: torch.Tensor, noise_scale=1.0):
    """var plus the learned noise (unchanged for fixed noise)."""
    if model.learn_noise:
        return var + torch.exp(params["raw_noise"])[:, None] * noise_scale
    return var
