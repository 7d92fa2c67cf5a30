"""UCI streaming-regression dataset loaders (the port's own copy of
``online_gp_tpu/data/uci.py``; numpy only).

Reference datasets (``online_gp/datasets/regression/``): powerplant
(xlsx), skillcraft (.mat), elevators, protein, 3droad, plus the MuJoCo
hopper/walker2d pickles. Shared semantics: min-max inputs to [-1, 1],
z-scored targets, seeded split with ``subsample_ratio``/``test_ratio=0.1``.

The repository ships no UCI files and nothing is downloaded, so each
loader reads a local file when present (``data_dir``) and otherwise falls
back to a *deterministic synthetic surrogate* with the same
dimensionality and preprocessing — clearly flagged in the returned
metadata so experiment logs can't silently conflate the two.

Real-file formats are probed in this order: npy, csv, then the
reference's own on-disk format — xlsx for powerplant
(``Folds5x2_pp.xlsx``), ``.mat`` 'data' matrices for
skillcraft/elevators/protein/3droad, and torch-pickle train/test splits
for hopper/walker2d (which, like the reference, are used pre-split and
un-normalized — ``online_gp/datasets/regression/hopper.py``).
Files are looked up both flat (``data_dir/<file>``) and in per-dataset
subdirectories (``data_dir/<name>/<file>``), matching the reference's
``/datasets/uci/<name>/`` convention.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from online_gp_torch.data.formats import read_mat, read_torch_pickle, read_xlsx
from online_gp_torch.data.preprocessing import minmax_scale, train_test_split, zscore

# name -> (input_dim, baseline_rmse from reference config/dataset/*.yaml:6)
UCI_DATASETS = {
    "skillcraft": (19, 1.8619),
    "powerplant": (4, 0.2169),
    "elevators": (18, 0.475),
    "protein": (9, 2.1227),
    "3droad": (2, 0.3711),
    "hopper": (11, None),
    "walker2d": (17, None),
}


@dataclass
class DatasetBundle:
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    name: str
    synthetic: bool
    baseline_rmse: Optional[float]

    @property
    def train_dataset(self):
        return self.train_x, self.train_y

    @property
    def test_dataset(self):
        return self.test_x, self.test_y


def _synthetic_surrogate(name: str, input_dim: int, n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic nonlinear surface with dataset-specific seed.

    The seed takes ``hash(name)``, which Python salts per process
    (``PYTHONHASHSEED``), so the surrogate is the same within one process
    and differs between processes. The JAX package's expression is kept
    as it is, so that both packages give one surrogate inside a process.
    """
    rng = np.random.default_rng(abs(hash(name)) % (2**32) + seed)
    x = rng.standard_normal((n, input_dim))
    w1 = rng.standard_normal((input_dim, 8)) / np.sqrt(input_dim)
    w2 = rng.standard_normal((8,))
    y = np.tanh(x @ w1) @ w2 + 0.5 * np.sin(2.0 * x[:, 0])
    y = y + 0.15 * rng.standard_normal(n)
    return x.astype(np.float32), y[:, None].astype(np.float32)


def load_uci(
    name: str,
    data_dir: Optional[str] = None,
    subsample_ratio: float = 1.0,
    test_ratio: float = 0.1,
    seed: int = 0,
    synthetic_n: int = 4000,
) -> DatasetBundle:
    if name not in UCI_DATASETS:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(UCI_DATASETS)}")
    input_dim, baseline = UCI_DATASETS[name]

    if data_dir and name in _MUJOCO_DIRS:
        bundle = _try_mujoco(name, data_dir, subsample_ratio, baseline)
        if bundle is not None:
            return bundle

    x = y = None
    synthetic = True
    if data_dir:
        candidates = [(name + ".npy", _load_npy), (name + ".csv", _load_csv)]
        candidates += _REAL_FILES.get(name, [])
        for fname, loader in candidates:
            path = _probe(data_dir, name, fname)
            if path is not None:
                x, y = loader(path)
                synthetic = False
                break
    if x is None:
        x, y = _synthetic_surrogate(name, input_dim, synthetic_n, seed)

    x = minmax_scale(np.asarray(x, np.float32))
    y = zscore(np.asarray(y, np.float32).reshape(len(x), -1))
    tr_x, tr_y, te_x, te_y = train_test_split(x, y, test_ratio, subsample_ratio, seed)
    return DatasetBundle(tr_x, tr_y, te_x, te_y, name, synthetic, baseline)


def _probe(data_dir: str, name: str, fname: str) -> Optional[str]:
    """Look for fname flat in data_dir or under a per-dataset subdir."""
    for sub in ("", name, _MUJOCO_DIRS.get(name, name)):
        path = os.path.join(data_dir, sub, fname) if sub else os.path.join(data_dir, fname)
        if os.path.exists(path):
            return path
    return None


def _load_xlsx(path: str):
    arr = read_xlsx(path)
    return arr[:, :-1], arr[:, -1:]


def _load_mat(path: str):
    arr = np.asarray(read_mat(path, key="data"), np.float64)
    return arr[:, :-1], arr[:, -1:]


_REAL_FILES = {
    "powerplant": [("Folds5x2_pp.xlsx", _load_xlsx), ("powerplant.xlsx", _load_xlsx)],
    "skillcraft": [("skillcraft.mat", _load_mat)],
    "elevators": [("elevators.mat", _load_mat)],
    "protein": [("protein.mat", _load_mat)],
    "3droad": [("3droad.mat", _load_mat)],
}

_MUJOCO_DIRS = {"hopper": "Hopper-v2", "walker2d": "Walker2d-v2"}


def _try_mujoco(
    name: str, data_dir: str, subsample_ratio: float, baseline
) -> Optional["DatasetBundle"]:
    """MuJoCo splits ship pre-split and are used un-normalized, truncated
    per split by subsample_ratio (reference ``hopper.py`` semantics)."""
    paths = {}
    for part in ("train_x", "train_y", "test_x", "test_y"):
        p = _probe(data_dir, name, part + ".pkl")
        if p is None:
            return None
        paths[part] = p
    arrs = {k: np.asarray(read_torch_pickle(p), np.float32) for k, p in paths.items()}
    n_tr = int(subsample_ratio * len(arrs["train_x"]))
    n_te = int(subsample_ratio * len(arrs["test_x"]))
    return DatasetBundle(
        arrs["train_x"][:n_tr],
        arrs["train_y"][:n_tr].reshape(n_tr, -1),
        arrs["test_x"][:n_te],
        arrs["test_y"][:n_te].reshape(n_te, -1),
        name,
        False,
        baseline,
    )


def _load_npy(path: str):
    arr = np.load(path)
    return arr[:, :-1], arr[:, -1:]


def _load_csv(path: str):
    try:
        from online_gp_torch.native import fast_csv_read

        arr = fast_csv_read(path, skip_header=1)
    except Exception:
        arr = np.loadtxt(path, delimiter=",", skiprows=1)
    return arr[:, :-1], arr[:, -1:]
