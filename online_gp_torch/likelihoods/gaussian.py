"""Gaussian likelihood helpers (port of
``online_gp_tpu/likelihoods/gaussian.py``).

The fixed-noise Gaussian with a multiplicative learnable second noise:
the observation noise is ``fixed_noise * sigma2``. The fixed per-point
noise lives in the WISKI caches and sigma2 in the params
(``raw_second_noise``); this module composes them and gives the diagonal
NLL used for evaluation.
"""

from __future__ import annotations

from typing import Optional

import torch

LOG_2PI = 1.8378770664093453


def fnmg_noise(fixed_noise: torch.Tensor, second_noise: Optional[torch.Tensor]) -> torch.Tensor:
    """noise = fixed * sigma2 (multiplicative second noise)."""
    if second_noise is None:
        return fixed_noise
    return fixed_noise * second_noise


def gaussian_nll(mean: torch.Tensor, var: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian negative log-likelihood, per element."""
    var = torch.clamp(var, min=1e-12)
    return 0.5 * (torch.log(var) + (y - mean) ** 2 / var + LOG_2PI)
