"""Banana two-class dataset (the port's own copy of
``online_gp_tpu/data/banana.py``; numpy only, the same arrays).

Two interleaved crescent clusters with overlap noise, inputs scaled to
[-1, 1], generated deterministically from ``seed``. The default noise
(0.45) puts a good nonparametric classifier in the high 0.80s to low
0.90s on the test split, the published banana benchmark's regime.
"""

from __future__ import annotations

import numpy as np

from online_gp_torch.data.preprocessing import minmax_scale, train_test_split


def banana_dataset(n: int = 2000, noise: float = 0.45, seed: int = 0):
    """(train x, train y, test x, test y): float32 inputs (., 2), int64
    labels in {0, 1}, a 20% test split."""
    rng = np.random.default_rng(seed)
    n_half = n // 2
    # two crescents, rotated and offset so they interlock
    t0 = rng.uniform(0.2 * np.pi, 1.3 * np.pi, n_half)
    t1 = rng.uniform(1.2 * np.pi, 2.3 * np.pi, n_half)
    x0 = np.stack([np.cos(t0), np.sin(t0)], axis=-1)
    x1 = np.stack([np.cos(t1) + 0.9, np.sin(t1) + 0.45], axis=-1)
    x = np.concatenate([x0, x1]).astype(np.float32)
    x += noise * rng.standard_normal(x.shape).astype(np.float32)
    y = np.concatenate([np.zeros(n_half), np.ones(n_half)]).astype(np.int64)
    perm = rng.permutation(len(x))
    x, y = minmax_scale(x[perm]).astype(np.float32), y[perm]
    return train_test_split(x, y, test_ratio=0.2, seed=seed)
