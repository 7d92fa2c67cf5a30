"""Hyperparameter priors (port of ``online_gp_tpu/kernels/priors.py``).

Priors are plain records evaluated on *constrained* values (the kernel's
``transforms`` of the raw params, ``exp`` where a param has none), summed
by :func:`log_prior_sum` and added into the Woodbury MLL by
``online_gp_torch.models.wiski.wiski_mll``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

_HALF_LOG_2PI = 0.9189385332046727


class GammaPrior(NamedTuple):
    """log p(x) = a*log(b) - lgamma(a) + (a-1)*log(x) - b*x."""

    concentration: float
    rate: float

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.concentration, self.rate
        const = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
        return a * torch.log(const(b)) - torch.lgamma(const(a)) + (a - 1.0) * torch.log(x) - b * x


class NormalPrior(NamedTuple):
    loc: float
    scale: float

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(torch.tensor(self.scale, dtype=x.dtype, device=x.device)) - _HALF_LOG_2PI


def log_prior_sum(
    priors: Optional[Dict[str, object]],
    params: Dict[str, torch.Tensor],
    transforms: Optional[Dict[str, object]] = None,
) -> torch.Tensor:
    """Sum of prior log-probs over named params.

    ``priors`` maps a raw-param name (e.g. ``raw_lengthscale``) to a prior
    evaluated on the constrained value; ``transforms`` (the kernel's
    raw-to-constrained map) defaults to exp for every param.
    """
    if not priors:
        return torch.zeros(())
    total = None
    for name, prior in priors.items():
        raw = params[name]
        tf = transforms.get(name) if transforms else None
        value = tf.forward(raw) if tf is not None else torch.exp(raw)
        term = torch.sum(prior.log_prob(value))
        total = term if total is None else total + term
    return total
