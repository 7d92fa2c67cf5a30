"""Real-data file-format parsers (xlsx / .mat / libsvm / HDF5 / torch
pickle): the port's own copy of ``online_gp_tpu/data/formats.py``, the
same readers with the same output.

The reference ingests its ten datasets through five on-disk formats:
xlsx for powerplant (``online_gp/datasets/regression/powerplant.py:17-41``),
MATLAB .mat with a ``data`` matrix for skillcraft/elevators/protein/3droad
(``skillcraft.py:14-20``), libsvm text for svmguide1
(``datasets/classification/svm_guide_1.py``), torch pickles for the MuJoCo
splits (``hopper.py``), and a pandas HDF5 for malaria
(``experiments/active_learning/data.py:19-89``). scipy, h5py and pandas are
imported lazily, inside the reader that needs them, so the module imports
where they are absent; xlsx is read by a self-contained OOXML parser
(no openpyxl). All readers return plain numpy.
"""

from __future__ import annotations

import re
import zipfile
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "read_xlsx",
    "read_mat",
    "read_libsvm",
    "read_torch_pickle",
    "read_pandas_hdf5",
]


# ---------------------------------------------------------------------------
# xlsx (minimal OOXML reader — numeric tables with an optional header row)
# ---------------------------------------------------------------------------

_CELL_REF = re.compile(r"([A-Z]+)(\d+)")


def _col_index(ref: str) -> int:
    """'A' -> 0, 'Z' -> 25, 'AA' -> 26 ..."""
    idx = 0
    for ch in ref:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_xlsx(path: str, sheet: int = 0) -> np.ndarray:
    """Read the numeric body of an xlsx worksheet into a (n, d) float array.

    Equivalent to ``np.array(pd.read_excel(path))`` for a plain numeric
    table: rows whose cells don't all parse as numbers (the header) are
    skipped. Only inline numbers and shared strings are handled — enough
    for UCI-style tables like powerplant's ``Folds5x2_pp.xlsx``.
    """
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        shared: List[str] = []
        if "xl/sharedStrings.xml" in names:
            root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            ns = {"m": root.tag.split("}")[0].strip("{")} if "}" in root.tag else {}
            tag = "m:si" if ns else "si"
            for si in root.findall(tag, ns):
                shared.append("".join(t.text or "" for t in si.iter() if t.tag.endswith("}t") or t.tag == "t"))
        sheets = sorted(n for n in names if re.match(r"xl/worksheets/sheet\d+\.xml$", n))
        if not sheets:
            raise ValueError(f"{path}: no worksheets found")
        root = ET.fromstring(zf.read(sheets[sheet]))

    def local(tag):
        return tag.split("}")[-1]

    rows: List[Dict[int, str]] = []
    for row_el in root.iter():
        if local(row_el.tag) != "row":
            continue
        cells: Dict[int, str] = {}
        for c in row_el:
            if local(c.tag) != "c":
                continue
            ref = c.attrib.get("r", "")
            mt = _CELL_REF.match(ref)
            col = _col_index(mt.group(1)) if mt else len(cells)
            ctype = c.attrib.get("t", "n")
            value = None
            for child in c:
                if local(child.tag) == "v":
                    value = child.text
                elif local(child.tag) == "is":  # inline string
                    value = "".join(t.text or "" for t in child.iter() if local(t.tag) == "t")
            if value is None:
                continue
            if ctype == "s":
                value = shared[int(value)]
            cells[col] = value
        if cells:
            rows.append(cells)

    numeric: List[List[float]] = []
    width = max((max(r) + 1 for r in rows), default=0)
    for cells in rows:
        try:
            vals = [float(cells[i]) for i in range(width)]
        except (KeyError, ValueError):
            continue  # header / ragged row
        numeric.append(vals)
    if not numeric:
        raise ValueError(f"{path}: no fully-numeric rows")
    return np.asarray(numeric, np.float64)


# ---------------------------------------------------------------------------
# MATLAB .mat
# ---------------------------------------------------------------------------


def read_mat(path: str, key: str = "data") -> np.ndarray:
    """Load a matrix from a .mat file (v5 via scipy; v7.3 via h5py)."""
    try:
        from scipy.io import loadmat

        blob = loadmat(path)
        if key not in blob:
            cand = [k for k in blob if not k.startswith("__")]
            raise KeyError(f"{path}: no {key!r} variable (has {cand})")
        return np.asarray(blob[key])
    except NotImplementedError:
        # MATLAB >= 7.3 files are HDF5
        import h5py

        with h5py.File(path, "r") as f:
            if key not in f:
                raise KeyError(f"{path}: no {key!r} dataset (has {list(f)})")
            # MATLAB stores column-major; transpose back
            return np.asarray(f[key]).T


# ---------------------------------------------------------------------------
# libsvm text
# ---------------------------------------------------------------------------


def read_libsvm(path: str, num_features: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``label idx:val idx:val ...`` lines (1-based indices).

    Returns dense (n, d) float32 features and (n,) int64 labels with
    negative labels mapped to 0 (the reference clamps via ``max(label, 0)``).
    """
    labels: List[int] = []
    entries: List[List[Tuple[int, float]]] = []
    max_idx = 0
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(max(int(float(parts[0])), 0))
            row = []
            for kv in parts[1:]:
                k, v = kv.split(":")
                k = int(k)
                max_idx = max(max_idx, k)
                row.append((k - 1, float(v)))
            entries.append(row)
    d = num_features or max_idx
    x = np.zeros((len(entries), d), np.float32)
    for i, row in enumerate(entries):
        for j, v in row:
            x[i, j] = v
    return x, np.asarray(labels, np.int64)


# ---------------------------------------------------------------------------
# torch pickles (MuJoCo splits)
# ---------------------------------------------------------------------------


def read_torch_pickle(path: str) -> np.ndarray:
    """torch.load a pickled tensor/array to numpy (cpu, no grad)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, torch.Tensor):
        return obj.detach().numpy()
    return np.asarray(obj)


# ---------------------------------------------------------------------------
# pandas-style HDF5 (malaria)
# ---------------------------------------------------------------------------


def read_pandas_hdf5(path: str, key: str = "full") -> Dict[str, np.ndarray]:
    """Read a column dict from an HDF5 file.

    Handles, in order: pandas.read_hdf (if pytables is importable), a
    pandas 'fixed'-format layout read raw through h5py (axis0 +
    blockN_items/blockN_values), and a plain layout with one dataset per
    column under the key group.
    """
    try:
        import pandas as pd

        df = pd.read_hdf(path, key)
        return {c: np.asarray(df[c]) for c in df.columns}
    except Exception:
        pass

    import h5py

    def _s(v):
        return v.decode() if isinstance(v, bytes) else str(v)

    with h5py.File(path, "r") as f:
        g = f[key] if key in f else f
        if "axis0" in g:  # pandas fixed format
            cols: Dict[str, np.ndarray] = {}
            i = 0
            while f"block{i}_items" in g:
                items = [_s(v) for v in np.asarray(g[f"block{i}_items"])]
                vals = np.asarray(g[f"block{i}_values"])
                for j, item in enumerate(items):
                    cols[item] = vals[:, j] if vals.ndim == 2 else vals
                i += 1
            if cols:
                return cols
        # plain one-dataset-per-column layout
        out = {}
        for name, ds in g.items():
            if isinstance(ds, h5py.Dataset):
                out[name] = np.asarray(ds)
        if not out:
            raise ValueError(f"{path}: unrecognized HDF5 layout under {key!r}")
        return out
