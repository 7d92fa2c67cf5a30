"""Array preprocessing (the port's own copy of
``online_gp_tpu/data/preprocessing.py``; numpy only, the same output bit
for bit): min-max inputs to [-1, 1], z-scored targets, a seeded split with
``subsample_ratio`` and ``test_ratio``, and class balancing."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def minmax_scale(x: np.ndarray) -> np.ndarray:
    """Scale each column to [-1, 1]."""
    lo = x.min(axis=0, keepdims=True)
    hi = x.max(axis=0, keepdims=True)
    span = np.where(hi - lo < 1e-12, 1.0, hi - lo)
    return 2.0 * (x - lo) / span - 1.0


def zscore(y: np.ndarray) -> np.ndarray:
    mu = y.mean(axis=0, keepdims=True)
    sd = y.std(axis=0, keepdims=True)
    return (y - mu) / np.where(sd < 1e-12, 1.0, sd)


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


def balance_classes(x: np.ndarray, y: np.ndarray, seed: int = 0):
    """Subsample the majority classes to the minority-class count."""
    rng = np.random.default_rng(seed)
    classes, counts = np.unique(y, return_counts=True)
    n_min = counts.min()
    keep = []
    for c in classes:
        idx = np.flatnonzero(y == c)
        keep.append(rng.permutation(idx)[:n_min])
    keep = rng.permutation(np.concatenate(keep))
    return x[keep], y[keep]
