"""Shuffled repeating mini-batch stream over host arrays (the port's copy
of the numpy path of ``online_gp_tpu/native/loader.py::BatchStream``).

The JAX package takes a C++ ``mt19937_64`` Fisher-Yates ring when its
native loader builds and this numpy ring otherwise; the port has the numpy
ring only: ``np.random.default_rng(seed)``, a fresh permutation each time
the ring wraps, rows gathered by numpy indexing (dtypes kept).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class BatchStream:
    def __init__(self, *arrays: np.ndarray, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("the arrays of a BatchStream must have one length")
        self.n = n
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._shuffle = shuffle
        self._perm = self._rng.permutation(n) if shuffle else np.arange(n)
        self._pos = 0

    def next(self) -> Tuple[np.ndarray, ...]:
        idx = np.empty((self.batch_size,), np.int64)
        for i in range(self.batch_size):
            if self._pos >= self.n:
                self._pos = 0
                if self._shuffle:
                    self._perm = self._rng.permutation(self.n)
            idx[i] = self._perm[self._pos]
            self._pos += 1
        return tuple(a[idx] for a in self.arrays)
