"""Malaria incidence dataset of the active-learning experiment (the port's
own copy of ``online_gp_tpu/data/malaria.py``; numpy only).

The reference's active-learning experiments load a 2012 malaria-incidence
HDF5 grid over Nigeria (lon/lat -> incidence and variance), unitize the
coordinates and stream pool points. A local ``.npz`` with keys x (n, 2),
y (n,) and y_var (n,) is read when given; otherwise a smooth deterministic
spatial field with heteroscedastic observation noise is generated from
``default_rng(seed)``, the same arrays as the JAX package's, bit for bit.
The HDF5 branch needs pandas or h5py and waits for the port of the
experiment layer (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


class MalariaData(NamedTuple):
    x: np.ndarray  # (n, 2) in [0, 1]^2
    y: np.ndarray  # (n,) standardized incidence
    y_var: np.ndarray  # (n,) observation variance
    synthetic: bool


def malaria_dataset(path: Optional[str] = None, n: int = 2500, seed: int = 0) -> MalariaData:
    if path and os.path.exists(path):
        if path.endswith((".h5", ".hdf5", ".hdf")):
            raise NotImplementedError(
                "the malaria HDF5 reader needs data/formats.read_pandas_hdf5, which the port has not "
                "yet (ROADMAP Queue 1 item 9, the experiment layer); pass an .npz with x, y, y_var"
            )
        blob = np.load(path)
        x, y, y_var = blob["x"], blob["y"], blob["y_var"]
        x = (x - x.min(0)) / (x.max(0) - x.min(0))
        y = (y - y.mean()) / y.std()
        return MalariaData(x.astype(np.float32), y.astype(np.float32), y_var.astype(np.float32), False)

    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(n, 2)).astype(np.float32)
    # smooth multi-bump incidence surface
    centers = rng.uniform(0.1, 0.9, size=(6, 2))
    scales = rng.uniform(0.08, 0.25, size=6)
    weights = rng.uniform(0.5, 2.0, size=6) * rng.choice([-1, 1], size=6)
    y = np.zeros(n)
    for c, s, w in zip(centers, scales, weights):
        y += w * np.exp(-np.sum((x - c) ** 2, axis=-1) / (2 * s**2))
    y = (y - y.mean()) / y.std()
    y_var = (0.05 + 0.1 * rng.uniform(size=n)).astype(np.float32)
    y = (y + np.sqrt(y_var) * rng.standard_normal(n)).astype(np.float32)
    return MalariaData(x, y, y_var, True)
