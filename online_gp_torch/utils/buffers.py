"""Host-side replay buffer for raw inputs (the port's own copy of
``online_gp_tpu/utils/buffers.py``).

The streaming wrappers refresh BatchNorm statistics with a 1024-sample
replay batch. The buffer grows on the host (numpy, amortized doubling) and
draws from ``np.random.default_rng(0)``, so a run draws the same batches as
the JAX package's.
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    def __init__(self, init: np.ndarray):
        init = np.asarray(init)
        self._cap = max(1024, 2 * len(init))
        self._buf = np.empty((self._cap,) + init.shape[1:], dtype=init.dtype)
        self._n = len(init)
        self._buf[: self._n] = init
        self._rng = np.random.default_rng(0)

    def __len__(self):
        return self._n

    def append(self, x: np.ndarray):
        x = np.asarray(x)
        need = self._n + len(x)
        if need > self._cap:
            while self._cap < need:
                self._cap *= 2
            new = np.empty((self._cap,) + self._buf.shape[1:], dtype=self._buf.dtype)
            new[: self._n] = self._buf[: self._n]
            self._buf = new
        self._buf[self._n : need] = x
        self._n = need

    def sample(self, batch_size: int = 1024) -> np.ndarray:
        idx = self._rng.integers(0, self._n, size=batch_size)
        return self._buf[idx]

    def all(self) -> np.ndarray:
        return self._buf[: self._n]
