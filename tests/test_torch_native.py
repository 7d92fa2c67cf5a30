"""The port's native stream loader (``online_gp_torch/native``) against the
JAX package's (``online_gp_tpu/native``).

- ``BatchStream``'s native branch (the C++ ``mt19937_64`` Fisher-Yates
  ring, the branch both packages take whenever g++ builds the library)
  draws the JAX package's index sequence over several wraps of the ring,
  starting with ``[14, 13, 11, 19, 6, 1, 2, 7]`` for
  ``BatchStream(np.arange(20, dtype=np.float32)[:, None], batch_size=8,
  seed=0)``; float32 rows come from the memcpy gather, other dtypes keep
  theirs. With both libraries turned off, the numpy rings agree too.
- ``fast_csv_read`` equals JAX's, also on a file with a line over the
  parser's 1 MiB buffer (rc 3, read by numpy) and on a missing file.
- Concurrent builds of the library (test workers) each replace the file
  whole, and the result loads.
- ``OnlineSVGPRegression.fit`` at its default ``batch_stream=True`` holds
  to the JAX wrapper's, as ``tests/test_torch_baselines.py`` holds the
  ``batch_stream=False`` fit: the JAX wrapper's float64 params carried
  across, float64 inputs, rtol 1e-5 of each quantity's largest entry.

The JAX loader compiles ``_stream_loader.so`` in place, so under several
test workers it can load the file while another worker's build is writing
it, and then stays off for the rest of its process. Where it is off and g++
is present, ``_jax_native_library`` builds the library for this file's
tests instead (the JAX loader's flags, a file of this process moved into
place whole) and points the JAX loader at it.
"""

import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu import api as japi
from online_gp_tpu.native import loader as j_loader
from online_gp_torch import api as tapi
from online_gp_torch import convert
from online_gp_torch.data import streaming_friedman
from online_gp_torch.native import BatchStream, fast_csv_read, loader, native_available

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_native_library(tmp_path_factory):
    if j_loader._lib() is not None or shutil.which("g++") is None:
        yield
        return
    out = tmp_path_factory.mktemp("jax_native") / "_stream_loader.so"
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", j_loader._SRC, "-o", str(tmp)], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_loader, "_SO", str(out))
        mp.setattr(j_loader, "_LIB", None)
        mp.setattr(j_loader, "_TRIED", False)
        yield


def test_first_batch_is_the_jax_native_ring():
    assert native_available() and j_loader.native_available()
    x = np.arange(20, dtype=np.float32)[:, None]
    got = BatchStream(x, batch_size=8, seed=0).next()[0]
    want = j_loader.BatchStream(x, batch_size=8, seed=0).next()[0]
    np.testing.assert_array_equal(got[:, 0], [14, 13, 11, 19, 6, 1, 2, 7])
    np.testing.assert_array_equal(got, want)
    # the SVGP wrapper's fit draws from it
    assert tapi.svgp.BatchStream is BatchStream


def _arrays(n):
    rng = np.random.default_rng(n)
    return (rng.normal(size=(n, 3)).astype(np.float32), rng.integers(0, 5, n), rng.normal(size=(n, 2, 2)),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("n,bs,shuffle,seed", [(20, 8, True, 0), (10, 3, True, 5), (12, 4, True, 1),
                                               (7, 7, False, 2), (5, 8, True, 3), (1, 2, True, 0)])
def test_native_ring_matches_the_jax_native_ring(n, bs, shuffle, seed):
    arrays = _arrays(n)
    want = j_loader.BatchStream(*arrays, batch_size=bs, shuffle=shuffle, seed=seed)
    got = BatchStream(*arrays, batch_size=bs, shuffle=shuffle, seed=seed)
    assert got._lib is not None and want._lib is not None
    for _ in range(max(3, 3 * n // bs + 1)):  # at least three wraps of the ring
        for a, b, src in zip(want.next(), got.next(), arrays):
            assert b.dtype == src.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n,bs,shuffle", [(10, 3, True), (12, 4, True), (7, 7, False), (5, 8, True)])
def test_numpy_ring_matches_the_jax_numpy_ring(monkeypatch, n, bs, shuffle):
    monkeypatch.setattr(j_loader, "_lib", lambda: None)
    monkeypatch.setattr(loader, "_lib", lambda: None)
    arrays = _arrays(n)
    want = j_loader.BatchStream(*arrays, batch_size=bs, shuffle=shuffle, seed=3)
    got = BatchStream(*arrays, batch_size=bs, shuffle=shuffle, seed=3)
    assert got._lib is None
    for _ in range(7):
        for a, b in zip(want.next(), got.next()):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)


def test_unequal_lengths_raise():
    with pytest.raises(ValueError, match="one length"):
        BatchStream(np.zeros((3, 1), np.float32), np.zeros(4), batch_size=2)


def _write_csv(path, rows, header="a,b,c"):
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(repr(float(v)) for v in r) + "\n")


@pytest.mark.parametrize("native", [True, False])
def test_fast_csv_read_matches_jax(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(j_loader, "_lib", lambda: None)
        monkeypatch.setattr(loader, "_lib", lambda: None)
    rng = np.random.default_rng(0)
    path = str(tmp_path / "data.csv")
    _write_csv(path, rng.normal(size=(57, 3)))
    with open(path, "a") as f:
        f.write("\n")  # a blank trailing line is skipped
    want, got = j_loader.fast_csv_read(path), fast_csv_read(path)
    assert got.dtype == np.float32 and got.shape == (57, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fast_csv_read(path, skip_header=2), j_loader.fast_csv_read(path, skip_header=2))


def test_fast_csv_read_over_long_line_goes_to_numpy(tmp_path):
    """A line over the parser's 1 MiB buffer: csv_dims returns 3 and both
    packages read the file with numpy, whole and right."""
    cols = 120_000  # ~1.3 MiB a line
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(3, cols)).astype(np.float32)
    path = str(tmp_path / "wide.csv")
    with open(path, "w") as f:
        f.write(",".join(f"c{i}" for i in range(cols)) + "\n")
        for r in arr:
            f.write(",".join(repr(float(v)) for v in r) + "\n")
    assert os.path.getsize(path) > 3 * (1 << 20)
    rows, ncols = ctypes.c_int64(), ctypes.c_int64()
    assert loader._lib().csv_dims(path.encode(), 1, ctypes.byref(rows), ctypes.byref(ncols)) == 3
    got, want = fast_csv_read(path), j_loader.fast_csv_read(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


def test_fast_csv_read_missing_file_raises(tmp_path):
    for fn in (fast_csv_read, j_loader.fast_csv_read):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "absent.csv"))


def test_concurrent_builds_each_replace_the_library_whole(tmp_path):
    out = tmp_path / "stream_loader.so"
    with ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: loader._build(out), range(4)))
    assert all(p == out for p in paths)
    assert sorted(os.listdir(tmp_path)) == ["stream_loader.so"]  # no temporary file left behind
    lib = ctypes.CDLL(str(out))
    lib.stream_create.restype = ctypes.c_void_p
    lib.stream_create.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_uint64]
    lib.stream_destroy.argtypes = [ctypes.c_void_p]
    lib.stream_destroy(lib.stream_create(4, 1, 0))



def test_a_library_that_does_not_load_is_built_again(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(loader, "_LIB", None)
    monkeypatch.setattr(loader, "_TRIED", False)
    loader.library_path().write_bytes(b"not a shared library")  # as one built on another machine
    assert native_available()
    x = np.arange(20, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(BatchStream(x, batch_size=8, seed=0).next()[0][:, 0], [14, 13, 11, 19, 6, 1, 2, 7])

# -- the SVGP fit at its default batch_stream=True ------------------------------


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, what):
    want, got = np.asarray(_np(want), np.float64), np.asarray(_np(got), np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _tree_close(want, got, what):
    if isinstance(want, dict):
        assert set(want) == set(got), what
        for k in want:
            _tree_close(want[k], got[k], f"{what}/{k}")
    else:
        _close(want, got, what)


@pytest.mark.parametrize("mode", ["grad", "closed_form"])
def test_svgp_default_fit_matches_jax(mode):
    tx, ty, ex, ey = streaming_friedman(n=300, num_dims=2, seed=0)
    tx, ty, ex, ey = (a.astype(np.float64) for a in (tx, ty, ex[:40], ey[:40]))
    kw = dict(num_inducing=16, lr=0.05, streaming=True, prior_beta=1e-3, online_beta=1e-3, variational_mode=mode)
    jr = japi.OnlineSVGPRegression(japi.IdentityStem(2), tx[:30], ty[:30], **kw)
    jr.params = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), jr.params)
    jr.opt_state = jr.opt.init(jr.params)
    tr = tapi.OnlineSVGPRegression(tapi.IdentityStem(2), tx[:30], ty[:30], device="cpu", **kw)
    convert.load_svgp(tr, jax.tree_util.tree_map(np.asarray, jr.params), {}, {}, device="cpu")
    # 2 epochs of 3 batches of 16 from 48 points: the ring wraps inside the fit
    jrec, trec = jr.fit(tx[:48], ty[:48], 2, batch_size=16), tr.fit(tx[:48], ty[:48], 2, batch_size=16)
    _close([r["train_loss"] for r in jrec], [r["train_loss"] for r in trec], "fit loss")
    _tree_close(jr.params, tr.params, "params after fit")
    for name in jr.old._fields:
        _close(getattr(jr.old, name), getattr(tr.old, name), f"old.{name}")
    for i in range(48, 52):
        _close(jr.update(tx[i : i + 1], ty[i : i + 1]), tr.update(tx[i : i + 1], ty[i : i + 1]), f"update {i}")
    for a, b in zip(jr.predict(ex), tr.predict(ex)):
        _close(a, b, "predict")
