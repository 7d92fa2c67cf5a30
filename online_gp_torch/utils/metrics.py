"""Evaluation metrics (port of ``online_gp_tpu/utils/metrics.py``).

Predictions in chunks of 1024, RMSE computed per chunk and averaged across
chunks (the reference's averaging, kept for metric parity), NLL as the
mean diagonal-Gaussian negative log-prob.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from online_gp_torch.likelihoods.gaussian import gaussian_nll
from online_gp_torch.logging.timing import span


def batched_rmse_nll(
    predict_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    inputs: torch.Tensor,
    targets: torch.Tensor,
    batch_size: int = 1024,
) -> Tuple[float, float]:
    """predict_fn(x) -> (mean, var) with shapes (b, T)."""
    n = inputs.shape[0]
    num_batches = max(1, -(-n // batch_size))
    rmse = nll = 0.0
    for start in range(0, n, batch_size):
        xb = inputs[start : start + batch_size]
        yb = targets[start : start + batch_size]
        mean, var = predict_fn(xb)
        with span("sync.metrics"):
            rmse += float(torch.sqrt(torch.mean((mean - yb) ** 2))) / num_batches
            nll += float(torch.mean(gaussian_nll(mean, var, yb))) / num_batches
    return rmse, nll


def accuracy(pred_labels: torch.Tensor, labels: torch.Tensor) -> float:
    return float(torch.mean((pred_labels == labels).to(torch.float32)))
