"""Bernoulli (probit) likelihood for variational GP classification (port of
``online_gp_tpu/likelihoods/bernoulli.py``).

A probit link with the classic closed forms:

  predictive p(y=1 | mu, s2) = Phi(mu / sqrt(1 + s2))
  E_q[log p(y|f)] by Gauss-Hermite quadrature on a fixed node count
"""

from __future__ import annotations

import numpy as np
import torch

_GH_NODES = 32
_gh_x, _gh_w = np.polynomial.hermite_e.hermegauss(_GH_NODES)  # weight e^{-x^2/2}
_gh_w = _gh_w / np.sqrt(2.0 * np.pi)


def bernoulli_probit_expected_log_prob(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """E_{f ~ N(mean, var)}[log Bernoulli(y | Phi(f))] per point.

    Args:
      y: (...,) in {0, 1} (or {-1, +1}); mean, var: (...,).
    """
    sign = torch.where(y > 0.5, 1.0, -1.0).to(mean.dtype)
    x = torch.as_tensor(_gh_x, dtype=mean.dtype, device=mean.device)
    w = torch.as_tensor(_gh_w, dtype=mean.dtype, device=mean.device)
    f = mean[..., None] + torch.sqrt(torch.clamp(var, min=1e-12))[..., None] * x
    return torch.sum(w * torch.special.log_ndtr(sign[..., None] * f), dim=-1)


def bernoulli_probit_predictive(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """p(y = 1) = Phi(mu / sqrt(1 + s2))."""
    return torch.special.ndtr(mean / torch.sqrt(1.0 + var))
