"""ctypes bindings for the native stream loader (the port's copy of
``online_gp_tpu/native/loader.py``, with its numpy branch).

``stream_loader.cpp`` (the JAX package's source, copied) is built with
g++ on first use, never at import:

    g++ -O3 -shared -fPIC -std=c++17 stream_loader.cpp -o build/online_gp_torch/stream_loader-<hash>.so

under ``build/`` at the repository root (git-ignored). The file name
carries a hash of the source and the flags. Each build writes a file of
its own and ``os.replace``s it into place, so processes that build at
once (test workers) never load a half-written library. A library under
that name that does not load (one built on another machine) is built
again, once. When g++ or the
library is missing every entry point takes its numpy branch, as the JAX
package's does; with the library, ``BatchStream`` draws the C++
``mt19937_64`` Fisher-Yates ring, the same index sequence as the JAX
package's default branch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().with_name("stream_loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "online_gp_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"stream_loader-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[Path]:
    """Compile to a file of this process's own, then move it into place."""
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=out.stem + "-", suffix=".so.tmp", dir=out.parent)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(path: Path) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = library_path()
        lib = _load(path) if path.exists() else None
        if lib is None and _build(path) is not None:
            lib = _load(path)
        if lib is None:
            return None
        lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.csv_dims.restype = ctypes.c_int
        lib.csv_read.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64]
        lib.csv_read.restype = ctypes.c_int
        lib.stream_create.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_uint64]
        lib.stream_create.restype = ctypes.c_void_p
        lib.stream_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.stream_next.restype = ctypes.c_int64
        lib.stream_destroy.argtypes = [ctypes.c_void_p]
        lib.stream_destroy.restype = None
        lib.gather_rows.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.gather_rows.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _lib() is not None


def fast_csv_read(path: str, skip_header: int = 1) -> np.ndarray:
    """Parse a numeric CSV to a float32 array (native when possible).

    Lines longer than the native parser's 1 MiB buffer make it return a
    distinct rc (3); those files go to numpy rather than being silently
    mis-parsed.
    """
    lib = _lib()
    if lib is None:
        return np.loadtxt(path, delimiter=",", skiprows=skip_header, dtype=np.float32)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.csv_dims(path.encode(), skip_header, ctypes.byref(rows), ctypes.byref(cols))
    if rc == 1:
        raise FileNotFoundError(path)
    if rc == 0:
        out = np.empty((rows.value, cols.value), np.float32)
        rc = lib.csv_read(path.encode(), skip_header,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows.value, cols.value)
        if rc == 0:
            return out
    # over-long line or short read: numpy is slower but always correct
    return np.loadtxt(path, delimiter=",", skiprows=skip_header, dtype=np.float32)


class BatchStream:
    """Shuffled repeating mini-batch stream over host arrays.

    The native Fisher-Yates ring and memcpy row gather when the library
    loads; otherwise ``np.random.default_rng(seed)`` with a fresh
    permutation each time the ring wraps. Dtypes are kept: the native
    gather serves only arrays that are already float32, everything else
    (float64 data, integer labels) is gathered by numpy indexing.
    """

    def __init__(self, *arrays: np.ndarray, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("the arrays of a BatchStream must have one length")
        self.n = n
        self.batch_size = batch_size
        self._lib = _lib()
        if self._lib is not None:
            self._handle = self._lib.stream_create(n, int(shuffle), seed)
            self._idx_buf = np.empty((batch_size,), np.int64)
        else:
            self._rng = np.random.default_rng(seed)
            self._shuffle = shuffle
            self._perm = self._rng.permutation(n) if shuffle else np.arange(n)
            self._pos = 0

    def next(self) -> Tuple[np.ndarray, ...]:
        bs = self.batch_size
        if self._lib is not None:
            idx_ptr = self._idx_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            self._lib.stream_next(self._handle, idx_ptr, bs)
            outs = []
            for a in self.arrays:
                if a.dtype == np.float32:
                    out = np.empty((bs,) + a.shape[1:], np.float32)
                    cols = int(np.prod(a.shape[1:])) if a.ndim > 1 else 1
                    self._lib.gather_rows(a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), idx_ptr, bs, cols,
                                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                    outs.append(out)
                else:
                    outs.append(a[self._idx_buf])
            return tuple(outs)
        idx = np.empty((bs,), np.int64)
        for i in range(bs):
            if self._pos >= self.n:
                self._pos = 0
                if self._shuffle:
                    self._perm = self._rng.permutation(self.n)
            idx[i] = self._perm[self._pos]
            self._pos += 1
        return tuple(a[idx] for a in self.arrays)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and getattr(self, "_lib", None) is not None:
            self._lib.stream_destroy(handle)
