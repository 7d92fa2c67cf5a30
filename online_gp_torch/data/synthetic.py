"""Synthetic regression datasets (the port's own copy of
``online_gp_tpu/data/synthetic.py``; numpy only, the same arrays bit for
bit)."""

from __future__ import annotations

import numpy as np

from online_gp_torch.data.preprocessing import train_test_split


def sin_cos_dataset(n: int = 1000, noise: float = 0.01, seed: int = 0):
    """Two inputs, two outputs (sin and cos of a linear blend), small noise:
    the reference's exact-regression test scenario."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)
    z = 1.5 * x[:, 0] - 0.8 * x[:, 1]
    y = np.stack([np.sin(2.0 * z), np.cos(2.0 * z)], axis=-1).astype(np.float32)
    y += noise * rng.standard_normal(y.shape).astype(np.float32)
    return train_test_split(x, y, test_ratio=0.2, seed=seed)


def streaming_friedman(n: int = 4000, noise: float = 0.1, seed: int = 0, num_dims: int = 5):
    """A Friedman-1 style nonlinear regression surface on [-1, 1]^num_dims,
    targets standardised; 10% of the points are the test split."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(n, num_dims)).astype(np.float32)
    u = (x + 1.0) / 2.0
    y = 10.0 * np.sin(np.pi * u[:, 0] * u[:, 1 % num_dims])
    if num_dims > 2:
        y = y + 20.0 * (u[:, 2] - 0.5) ** 2
    if num_dims > 3:
        y = y + 10.0 * u[:, 3]
    if num_dims > 4:
        y = y + 5.0 * u[:, 4]
    y = (y - y.mean()) / y.std()
    y = (y + noise * rng.standard_normal(y.shape)).astype(np.float32)[:, None]
    return train_test_split(x, y, test_ratio=0.1, seed=seed)
