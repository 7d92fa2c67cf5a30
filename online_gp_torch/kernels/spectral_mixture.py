"""Spectral mixture kernel (Wilson & Adams 2013; port of
``online_gp_tpu/kernels/spectral_mixture.py``):

    k(tau) = sum_q  w_q  prod_d  exp(-2 pi^2 tau_d^2 s_qd^2) cos(2 pi tau_d mu_qd)

Each component is separable across input dimensions, so on an inducing
grid K_uu is a sum of Q Kronecker-of-Toeplitz matrices: the grid assembly
(:mod:`online_gp_torch.kernels.grid_kernel`) sums the per-component
Kronecker chains (dense) or Toeplitz-FFT passes (``use_toeplitz``).

Parameters (raw = log space, batch dims leading as for the other kernels):
  ``raw_sm_weights``: (..., Q)      log mixture weights
  ``raw_sm_means``:   (..., Q, D)   log spectral means (frequencies)
  ``raw_sm_scales``:  (..., Q, D)   log spectral standard deviations
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from online_gp_torch.kernels.base import Kernel, Params

_TWO_PI = 2.0 * math.pi


class SpectralMixtureKernel(Kernel):
    name = "spectral_mixture"

    def __init__(self, num_mixtures: int = 3):
        super().__init__()
        if num_mixtures < 1:
            raise ValueError("num_mixtures must be >= 1")
        self.num_mixtures = num_mixtures

    @property
    def num_components(self) -> int:
        """A mixture kernel: the grid assembly sums over its components."""
        return self.num_mixtures

    def init_params(
        self,
        num_dims: int,
        batch_shape=(),
        lengthscale: float = 0.693,
        outputscale: float = 1.0,
        dtype=torch.float32,
        device="cuda",
    ) -> Params:
        """Deterministic spread init: component means evenly spaced over a
        band of frequencies up to ~1/(2 lengthscale), scales at a tenth of
        the band, equal weights summing to ``outputscale``
        (:func:`sm_init_from_data` is the data-driven one)."""
        Q, D = self.num_mixtures, num_dims
        bshape = tuple(batch_shape)
        band = 0.5 / max(lengthscale, 1e-3)
        means = torch.linspace(band / (Q + 1), band * Q / (Q + 1), Q, dtype=dtype, device=device)
        return {
            "raw_sm_weights": torch.full(bshape + (Q,), math.log(outputscale / Q), dtype=dtype, device=device),
            "raw_sm_means": torch.log(means)[:, None].expand(bshape + (Q, D)).clone(),
            "raw_sm_scales": torch.full(bshape + (Q, D), math.log(band / 10.0), dtype=dtype, device=device),
        }

    # -- component factors (read by kernels/grid_kernel.py) -----------------

    def component_factor_1d(self, params: Params, q: int, d: int, g: torch.Tensor, include_weight: bool) -> torch.Tensor:
        """Per-component per-dimension grid factor: (..., m_d, m_d)."""
        return self._component_profile(params, q, d, g[:, None] - g[None, :], include_weight)

    def component_factor_col(self, params: Params, q: int, d: int, g: torch.Tensor, include_weight: bool) -> torch.Tensor:
        """First column of the (Toeplitz) component factor: (..., m_d)."""
        return self._component_profile(params, q, d, g - g[0], include_weight)

    def _component_profile(self, params, q, d, tau, include_weight):
        pad = (None,) * tau.ndim
        mu = torch.exp(params["raw_sm_means"][..., q, d])[(..., *pad)]
        sc = torch.exp(params["raw_sm_scales"][..., q, d])[(..., *pad)]
        k = torch.exp(-2.0 * math.pi**2 * (tau * sc) ** 2) * torch.cos(_TWO_PI * tau * mu)
        if include_weight:
            k = torch.exp(params["raw_sm_weights"][..., q])[(..., *pad)] * k
        return k

    def matrix(self, params: Params, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """Dense kernel matrix (..., n1, n2)."""
        w = torch.exp(params["raw_sm_weights"])  # (..., Q)
        mu = torch.exp(params["raw_sm_means"])[..., :, None, None, :]  # (..., Q, 1, 1, D)
        sc = torch.exp(params["raw_sm_scales"])[..., :, None, None, :]
        tau = (x1[:, None, :] - x2[None, :, :])[None]  # (1, n1, n2, D)
        comp = torch.exp(-2.0 * math.pi**2 * (tau * sc) ** 2) * torch.cos(_TWO_PI * tau * mu)
        comp = torch.prod(comp, dim=-1)  # (..., Q, n1, n2)
        return torch.sum(w[..., :, None, None] * comp, dim=-3)

    def data_init_params(self, x, y, batch_shape=(), dtype=torch.float32, device="cuda") -> Params:
        """Data-driven init (the wrappers use it when a kernel has one:
        spectral mixture fits depend on their start)."""
        return sm_init_from_data(self, x, y, batch_shape, dtype=dtype, device=device)

    def profile(self, r):
        raise NotImplementedError("a mixture kernel has no single per-dimension profile")

    def factor_1d(self, params, d, g, include_scale):
        raise NotImplementedError("use component_factor_1d (num_components > 1)")

    def factor_col(self, params, d, g, include_scale):
        raise NotImplementedError("use component_factor_col (num_components > 1)")


def sm_init_from_data(
    kernel: SpectralMixtureKernel,
    x,
    y,
    batch_shape=(),
    dtype=torch.float32,
    device="cuda",
) -> Dict:
    """Empirical-spectrum init (gpytorch's ``initialize_from_data_empspect``
    analog), deterministic given the data: per input dimension, resample y
    onto a regular grid, FFT, and put the component means on the Q
    strongest peaks; scales at a tenth of the means, weights from the peak
    powers normalised to var(y). Computed in float64 numpy on the host."""
    Q, D = kernel.num_mixtures, x.shape[-1]
    bshape = tuple(batch_shape)
    as_np = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    x_np = np.asarray(as_np(x), np.float64)
    y_np = np.asarray(as_np(y), np.float64).reshape(x_np.shape[0], -1).mean(axis=-1)
    y_np = y_np - y_np.mean()
    n_grid = int(min(2048, 4 * x_np.shape[0]))

    means = np.empty((Q, D))
    weights_acc = np.zeros((Q,))
    for d in range(D):
        order = np.argsort(x_np[:, d])
        xd, yd = x_np[order, d], y_np[order]
        lo, hi = float(xd[0]), float(xd[-1])
        span = max(hi - lo, 1e-6)
        grid_t = np.linspace(lo, hi, n_grid)
        yg = np.interp(grid_t, xd, yd)
        spec = np.abs(np.fft.rfft(yg)) ** 2
        freqs = np.fft.rfftfreq(n_grid, d=span / (n_grid - 1))
        spec[0] = 0.0  # drop DC
        top = np.argsort(spec)[::-1][:Q]
        # strongest peak first; harmonically spaced fallbacks
        for qi in range(Q):
            if qi < len(top) and spec[top[qi]] > 0:
                means[qi, d] = max(freqs[top[qi]], 0.25 / span)
                weights_acc[qi] += spec[top[qi]]
            else:
                means[qi, d] = (qi + 1) * 0.5 / span
    scales = np.maximum(means / 10.0, 1e-3)
    var_y = max(float(np.var(y_np)), 1e-6)
    w = weights_acc / max(weights_acc.sum(), 1e-12) * var_y
    w = np.maximum(w, 1e-4 * var_y)

    def log_bc(a, shape):
        return torch.log(torch.tensor(np.broadcast_to(a, bshape + shape).copy(), dtype=dtype, device=device))

    return {
        "raw_sm_weights": log_bc(w, (Q,)),
        "raw_sm_means": log_bc(means, (Q, D)),
        "raw_sm_scales": log_bc(scales, (Q, D)),
    }
