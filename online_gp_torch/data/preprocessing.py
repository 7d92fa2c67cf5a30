"""Array preprocessing (the port's own copy of the parts of
``online_gp_tpu/data/preprocessing.py`` it uses; numpy only, the same
output bit for bit)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def minmax_scale(x: np.ndarray) -> np.ndarray:
    """Scale each column to [-1, 1]."""
    lo = x.min(axis=0, keepdims=True)
    hi = x.max(axis=0, keepdims=True)
    span = np.where(hi - lo < 1e-12, 1.0, hi - lo)
    return 2.0 * (x - lo) / span - 1.0


def train_test_split(
    x: np.ndarray,
    y: np.ndarray,
    test_ratio: float = 0.1,
    subsample_ratio: float = 1.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A seeded shuffle, an optional subsample, then (train x, train y,
    test x, test y) with the first ``test_ratio`` of the kept points as the
    test split."""
    rng = np.random.default_rng(seed)
    n = len(x)
    keep = int(n * subsample_ratio)
    perm = rng.permutation(n)[:keep]
    x, y = x[perm], y[perm]
    n_test = int(keep * test_ratio)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]
