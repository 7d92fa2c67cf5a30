"""Dirichlet-based GP classification transform (port of
``online_gp_tpu/likelihoods/dirichlet.py``).

After Milios et al. 2018, "Dirichlet-based Gaussian Processes for
Large-scale Calibrated Classification": labels become per-class regression
targets with per-class heteroscedastic noise, so a fixed-noise (WISKI)
regressor does calibrated classification.

    alpha    = alpha_eps + onehot(y)
    sigma2_i = log(1/alpha + 1)
    y_tilde  = log(alpha) - sigma2_i / 2
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def dirichlet_transform(
    labels: torch.Tensor, num_classes: int, alpha_eps: float = 0.01, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer labels (n,) in [0, num_classes) to regression targets and
    noise: returns targets, alpha and sigma2, each (n, C), in ``dtype``."""
    onehot = F.one_hot(labels.long(), num_classes).to(dtype)
    alpha = alpha_eps + onehot
    sigma2 = torch.log(1.0 / alpha + 1.0)
    targets = torch.log(alpha) - 0.5 * sigma2
    return targets, alpha, sigma2
