"""The port's file-format readers and dataset loaders against the JAX
package's, on the checked-in fixtures (``tests/fixtures``, copied into
``tmp_path``) and on the synthetic surrogates: every reader of
``tests/data/test_formats.py`` array for array (dtype and shape too),
``load_uci`` (surrogate, npy, csv, xlsx, .mat and the MuJoCo pre-split
branches), ``svmguide1_dataset`` and ``criteo_dataset`` (surrogate and file
branches), ``zscore`` / ``balance_classes``, and malaria's ``.h5`` branch.

``load_uci``'s surrogate seeds with ``abs(hash(name))``, which Python
salts per process: the two packages agree inside one process (here), and
a run in another process draws another surrogate (ROADMAP, "Reference
behaviour")."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from online_gp_tpu.data import classification_extra as j_extra
from online_gp_tpu.data import formats as j_formats
from online_gp_tpu.data import preprocessing as j_pre
from online_gp_tpu.data import uci as j_uci
from online_gp_tpu.data.malaria import malaria_dataset as j_malaria
from online_gp_torch.data import (
    DatasetBundle,
    balance_classes,
    criteo_dataset,
    load_uci,
    malaria_dataset,
    svmguide1_dataset,
    zscore,
)
from online_gp_torch.data import formats

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"


@pytest.fixture
def fix(tmp_path):
    """The fixtures, copied into a directory of the test's own."""
    dst = tmp_path / "fixtures"
    shutil.copytree(FIX, dst)
    return dst


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_read_xlsx_matches_jax(fix):
    got = formats.read_xlsx(str(fix / "tiny.xlsx"))
    _same(got, j_formats.read_xlsx(str(fix / "tiny.xlsx")))
    np.testing.assert_allclose(got, np.load(fix / "tiny_xlsx_expected.npy"), rtol=1e-12)


def test_read_mat_matches_jax(fix):
    got = formats.read_mat(str(fix / "tiny.mat"))
    _same(got, j_formats.read_mat(str(fix / "tiny.mat")))
    np.testing.assert_allclose(got, np.load(fix / "tiny_mat_expected.npy"), rtol=1e-12)
    with pytest.raises(KeyError, match="no 'nope'"):
        formats.read_mat(str(fix / "tiny.mat"), key="nope")


@pytest.mark.parametrize("num_features", [None, 6])
def test_read_libsvm_matches_jax(fix, num_features):
    got = formats.read_libsvm(str(fix / "tiny.libsvm"), num_features)
    _same(got, j_formats.read_libsvm(str(fix / "tiny.libsvm"), num_features))
    np.testing.assert_array_equal(got[1], [1, 0, 0, 1])  # -1 clamps to 0


@pytest.mark.parametrize("part", ["train_x", "train_y", "test_x", "test_y"])
def test_read_torch_pickle_matches_jax(fix, part):
    path = str(fix / "Hopper-v2" / f"{part}.pkl")
    _same(formats.read_torch_pickle(path), j_formats.read_torch_pickle(path))


@pytest.mark.parametrize("fname", ["tiny_malaria_plain.h5", "tiny_malaria_fixed.h5"])
def test_read_pandas_hdf5_matches_jax(fix, fname):
    got = formats.read_pandas_hdf5(str(fix / fname))
    _same(got, j_formats.read_pandas_hdf5(str(fix / fname)))
    expected = np.load(fix / "tiny_malaria_expected.npz")
    np.testing.assert_allclose(got["longitude"], expected["lon"])
    np.testing.assert_allclose(got["std_dev"], expected["std"])


@pytest.mark.parametrize("fname", ["tiny_malaria_plain.h5", "tiny_malaria_fixed.h5"])
def test_malaria_hdf5_branch_matches_jax(fix, fname):
    got, want = malaria_dataset(str(fix / fname)), j_malaria(str(fix / fname))
    assert not got.synthetic and not want.synthetic
    _same(tuple(got[:3]), tuple(want[:3]))


def test_preprocessing_matches_jax():
    rng = np.random.default_rng(2)
    y = rng.normal(size=(41, 2)).astype(np.float32)
    y[:, 1] = 3.0  # a constant column keeps its guard
    _same(zscore(y), j_pre.zscore(y))
    x, labels = rng.normal(size=(50, 3)), rng.integers(0, 3, 50)
    _same(balance_classes(x, labels, seed=4), j_pre.balance_classes(x, labels, seed=4))


def _bundle_same(got, want):
    assert isinstance(got, DatasetBundle)
    for f in ("train_x", "train_y", "test_x", "test_y"):
        _same(getattr(got, f), getattr(want, f))
    assert (got.name, got.synthetic, got.baseline_rmse) == (want.name, want.synthetic, want.baseline_rmse)
    _same(got.train_dataset, want.train_dataset)


@pytest.mark.parametrize("name,kw", [
    ("skillcraft", dict()), ("powerplant", dict(seed=3, subsample_ratio=0.5)),
    ("3droad", dict(synthetic_n=500, test_ratio=0.2)), ("hopper", dict(data_dir="absent")),
])
def test_load_uci_surrogate_matches_jax(name, kw):
    got, want = load_uci(name, **kw), j_uci.load_uci(name, **kw)
    assert got.synthetic
    _bundle_same(got, want)


def test_load_uci_surrogate_is_salted_per_process():
    """The reference behaviour the port keeps: ``hash(name)`` differs from
    one interpreter to the next, and so does the surrogate."""
    code = "from online_gp_torch.data import load_uci; print(float(load_uci('elevators', synthetic_n=64).train_y.sum()))"
    sums = {
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, capture_output=True, text=True,
                       env={**os.environ, "PYTHONHASHSEED": str(s)}, timeout=120).stdout.strip()
        for s in (1, 2)
    }
    assert len(sums) == 2


def test_load_uci_file_branches_match_jax(fix, tmp_path):
    data = tmp_path / "data"
    (data / "powerplant").mkdir(parents=True)
    shutil.copy(fix / "tiny.xlsx", data / "powerplant" / "Folds5x2_pp.xlsx")
    shutil.copy(fix / "tiny.mat", data / "skillcraft.mat")
    shutil.copytree(fix / "Hopper-v2", data / "Hopper-v2")
    rng = np.random.default_rng(7)
    np.save(data / "protein.npy", rng.normal(size=(30, 10)))
    with open(data / "elevators.csv", "w") as f:
        f.write(",".join(f"c{i}" for i in range(19)) + "\n")
        for row in rng.normal(size=(25, 19)).astype(np.float32):
            f.write(",".join(repr(float(v)) for v in row) + "\n")
    for name in ("powerplant", "skillcraft", "hopper", "protein", "elevators"):
        got, want = load_uci(name, data_dir=str(data), seed=1), j_uci.load_uci(name, data_dir=str(data), seed=1)
        assert not got.synthetic
        _bundle_same(got, want)
    with pytest.raises(ValueError, match="unknown dataset"):
        load_uci("nope")


@pytest.mark.parametrize("balance", [True, False])
def test_extra_classification_sets_match_jax(fix, tmp_path, balance):
    _same(svmguide1_dataset(seed=2, balance=balance), j_extra.svmguide1_dataset(seed=2, balance=balance))
    _same(criteo_dataset(seed=1, num_rows=500, balance=balance),
          j_extra.criteo_dataset(seed=1, num_rows=500, balance=balance))
    (tmp_path / "svmguide1").write_bytes((fix / "tiny.libsvm").read_bytes())
    got = svmguide1_dataset(data_dir=str(tmp_path), balance=balance)
    assert got[-1] is False
    _same(got, j_extra.svmguide1_dataset(data_dir=str(tmp_path), balance=balance))
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.integers(0, 2, (40, 1)), rng.normal(size=(40, 13)) * 10], axis=1)
    np.savetxt(tmp_path / "criteo.csv", rows, delimiter=",")
    got = criteo_dataset(data_dir=str(tmp_path), balance=balance)
    assert got[-1] is False
    _same(got, j_extra.criteo_dataset(data_dir=str(tmp_path), balance=balance))
