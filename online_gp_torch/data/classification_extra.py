"""Additional classification dataset loaders (svmguide1, criteo): the
port's own copy of ``online_gp_tpu/data/classification_extra.py``.

Reference loaders (``online_gp/datasets/classification/svm_guide_1.py``,
``criteo.py``) read libsvm/csv files from disk. Network-free equivalents:
read a local file when present, otherwise generate a deterministic
surrogate with the same dimensionality/class balance, flagged in the
result. Preprocessing matches the reference family: min-max inputs to
[-1, 1], optional class balancing.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from online_gp_torch.data.formats import read_libsvm
from online_gp_torch.data.preprocessing import balance_classes, minmax_scale, train_test_split


def _synthetic_classes(input_dim: int, n: int, seed: int, sep: float = 1.2):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((input_dim,))
    w /= np.linalg.norm(w)
    x = rng.standard_normal((n, input_dim))
    logits = sep * (x @ w) + 0.6 * np.sin(2.0 * x[:, 0])
    y = (logits + 0.5 * rng.standard_normal(n) > 0).astype(np.int64)
    return x.astype(np.float32), y


def svmguide1_dataset(data_dir: Optional[str] = None, seed: int = 0, balance: bool = True):
    """4-feature binary benchmark (reference svm_guide_1.py; its loader
    reads ``train.libsvm`` from the dataset dir)."""
    x = y = None
    if data_dir:
        for name in ("svmguide1", "svmguide1.t", "train.libsvm"):
            for path in (os.path.join(data_dir, name), os.path.join(data_dir, "svmguide1", name)):
                if os.path.exists(path):
                    x, y = read_libsvm(path, num_features=4)
                    break
            if x is not None:
                break
    synthetic = x is None
    if synthetic:
        x, y = _synthetic_classes(4, 4000, seed)
    if balance:
        x, y = balance_classes(x, y, seed)
    x = minmax_scale(x).astype(np.float32)
    return (*train_test_split(x, y, test_ratio=0.2, seed=seed), synthetic)


def criteo_dataset(data_dir: Optional[str] = None, seed: int = 0, num_rows: int = 8000,
                   balance: bool = True):
    """Criteo CTR subsample: 13 numeric features, binary label
    (reference criteo.py)."""
    x = y = None
    if data_dir:
        path = os.path.join(data_dir, "criteo.csv")
        if os.path.exists(path):
            arr = np.genfromtxt(path, delimiter=",", max_rows=num_rows, filling_values=0.0)
            y = arr[:, 0].astype(np.int64)
            x = arr[:, 1:14].astype(np.float32)
    synthetic = x is None
    if synthetic:
        x, y = _synthetic_classes(13, num_rows, seed, sep=0.8)
    if balance:
        x, y = balance_classes(x, y, seed)
    x = minmax_scale(np.log1p(np.abs(x)) * np.sign(x)).astype(np.float32)
    return (*train_test_split(x, y, test_ratio=0.2, seed=seed), synthetic)
