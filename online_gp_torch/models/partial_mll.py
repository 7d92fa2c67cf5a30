"""Sherman-Morrison partial MLL, the O(m^2) online stem objective (port of
``online_gp_tpu/models/partial_mll.py``).

With the *detached* grid-space predictive covariance cache
M = (K^{-1} + WW')^{-1} and cache W D^{-1} y, and differentiable
interpolation weights w = w(stem(x')) for a new point, the rank-1
Sherman-Morrison identities give a cheap objective whose gradient trains
the feature extractor online:

  quad   = z' M z - (v' z)^2 / (1 + v' w),  z = Wy + w*y,  v = M w
  logdet = log(1 + v' w)
  pmll   = (quad - logdet) / 2 / (num_seen + 1)

A batch of new points is scored per point against the shared caches and
summed; the JAX package's ``vmap`` over points is a point dimension of the
tensors here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.models.wiski import (
    WiskiModel,
    WiskiState,
    _second_noise,
    wiski_prediction_caches,
)
from online_gp_torch.ops.interp import dense_w, interp_coeffs
from online_gp_torch.ops.precision import f32_matmul_precision


def sm_partial_mll(
    model: WiskiModel,
    params: Dict,
    state: WiskiState,
    new_x: torch.Tensor,
    new_y: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG,
    caches: Optional[tuple] = None,
) -> torch.Tensor:
    """Per-output partial MLL for a batch of new points.

    Args:
      new_x: (q, D) differentiable features (gradients flow to the stem
        through the interpolation weights only).
      new_y: (q, B) targets.
      caches: optional ``(mean_cache, cov_cache)`` from
        :func:`wiski_prediction_caches` (or their O(m^2) conditioning);
        otherwise they are built here. Either way they are used detached:
        they are built under ``torch.no_grad()``, so Q needs no grad and
        kernel K6 factors it on the card.

    Returns (B,); callers take ``-sum()`` as the stem loss.
    """
    if caches is None:
        with torch.no_grad():
            caches = wiski_prediction_caches(
                model, params, state, cfg.replace(skip_posterior_variances=False)
            )
    M = caches[1].detach()  # (B, m, m)
    Wy = state.wty.detach()  # (B, m, 1)
    s2 = _second_noise(model, params)
    s2 = None if s2 is None else s2.detach()

    m = model.grid.num_points
    idx, w = interp_coeffs(model.grid, new_x, detach=False)
    wcols = dense_w(idx, w, m)[None]  # (1, m, q): one column per point
    y = new_y.reshape(-1, model.num_outputs).T[:, None, :]  # (B, 1, q)
    with f32_matmul_precision():
        z = Wy + wcols * y  # (B, m, q)
        Mw = M @ wcols  # (B, m, q)
        Mz = M @ z
    sm_div = 1.0 + torch.sum(Mw * wcols, dim=-2)  # (B, q)
    quad1 = torch.sum(z * Mz, dim=-2)
    quad3 = torch.sum(Mw * z, dim=-2) ** 2 / sm_div
    quad = quad1 - quad3
    if s2 is not None:
        quad = quad / s2[:, None]
    per_point = (quad - torch.log(sm_div)) / 2.0  # (B, q)
    return torch.sum(per_point, dim=-1) / (state.num_data + 1.0)
