"""Malaria incidence dataset of the active-learning experiment (the port's
own copy of ``online_gp_tpu/data/malaria.py``; numpy only).

The reference's active-learning experiments load a 2012 malaria-incidence
HDF5 grid over Nigeria (lon/lat -> incidence and variance), unitize the
coordinates and stream pool points. A local ``.npz`` with keys x (n, 2),
y (n,) and y_var (n,) is read when given; otherwise a smooth deterministic
spatial field with heteroscedastic observation noise is generated from
``default_rng(seed)``, the same arrays as the JAX package's, bit for bit.
An ``.h5`` / ``.hdf5`` / ``.hdf`` path is read as the reference's HDF5
frame through :func:`~online_gp_torch.data.formats.read_pandas_hdf5`
(pandas or h5py, imported when such a file is read).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


def _load_malaria_hdf5(path: str):
    """The reference's HDF5 layout (``experiments/active_learning/data.py``):
    a 'full' frame with longitude/latitude/year/mean/std_dev/is_ng columns.
    Rows are filtered to is_ng == 1 (and, when a year column exists, to the
    2012 training year the AL pool streams from); y_var = std_dev^2 + 1e-6.
    """
    from online_gp_torch.data.formats import read_pandas_hdf5

    cols = read_pandas_hdf5(path, key="full")
    mask = np.ones(len(cols["mean"]), bool)
    if "is_ng" in cols:
        mask &= np.asarray(cols["is_ng"]) == 1
    if "year" in cols:
        years = np.asarray(cols["year"])
        mask &= years == years[mask].min()
    x = np.stack([np.asarray(cols["longitude"])[mask], np.asarray(cols["latitude"])[mask]], axis=-1)
    y = np.asarray(cols["mean"])[mask]
    y_var = np.asarray(cols["std_dev"])[mask] ** 2 + 1e-6
    return x, y, y_var


class MalariaData(NamedTuple):
    x: np.ndarray  # (n, 2) in [0, 1]^2
    y: np.ndarray  # (n,) standardized incidence
    y_var: np.ndarray  # (n,) observation variance
    synthetic: bool


def malaria_dataset(path: Optional[str] = None, n: int = 2500, seed: int = 0) -> MalariaData:
    if path and os.path.exists(path):
        if path.endswith((".h5", ".hdf5", ".hdf")):
            x, y, y_var = _load_malaria_hdf5(path)
        else:
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
