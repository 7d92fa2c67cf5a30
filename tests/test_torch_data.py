"""The port's own copies of the data helpers against the JAX package's:
``banana_dataset``, ``sin_cos_dataset`` and ``streaming_friedman`` array
for array (the same bits and dtypes), ``minmax_scale`` and
``train_test_split`` on their own, and the minibatch ring
``online_gp_torch.utils.batch_stream.BatchStream`` batch for batch against
the numpy path of the JAX package's ``BatchStream`` (its native loader
turned off)."""

import numpy as np
import pytest

from online_gp_tpu.data import banana_dataset as j_banana
from online_gp_tpu.data import sin_cos_dataset as j_sin_cos
from online_gp_tpu.data import streaming_friedman as j_friedman
from online_gp_tpu.native import loader as j_loader
from online_gp_tpu.data.preprocessing import minmax_scale as j_minmax
from online_gp_tpu.data.preprocessing import train_test_split as j_split
from online_gp_torch.data import banana_dataset, minmax_scale, sin_cos_dataset, streaming_friedman, train_test_split
from online_gp_torch.utils.batch_stream import BatchStream


@pytest.mark.parametrize("kw", [dict(), dict(n=1200, seed=0), dict(n=301, noise=0.2, seed=3)])
def test_banana_matches_the_jax_package(kw):
    for want, got in zip(j_banana(**kw), banana_dataset(**kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_preprocessing_matches_the_jax_package():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(57, 3)).astype(np.float32)
    x[:, 2] = 4.0  # a constant column keeps its span guard
    y = rng.integers(0, 3, 57)
    np.testing.assert_array_equal(minmax_scale(x), j_minmax(x))
    for want, got in zip(j_split(x, y, 0.3, 0.8, seed=5), train_test_split(x, y, 0.3, 0.8, seed=5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [
    ("sin_cos", dict()), ("sin_cos", dict(n=600, noise=0.05, seed=2)),
    ("friedman", dict()), ("friedman", dict(n=4000, num_dims=5, seed=0)), ("friedman", dict(n=1200, num_dims=2)),
    ("friedman", dict(n=500, noise=0.3, seed=4, num_dims=3)),
])
def test_synthetic_generators_match_the_jax_package(name, kw):
    j_fn, t_fn = {"sin_cos": (j_sin_cos, sin_cos_dataset), "friedman": (j_friedman, streaming_friedman)}[name]
    for want, got in zip(j_fn(**kw), t_fn(**kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,bs,shuffle", [(10, 3, True), (12, 4, True), (7, 7, False), (5, 8, True)])
def test_batch_stream_matches_the_jax_numpy_ring(monkeypatch, n, bs, shuffle):
    monkeypatch.setattr(j_loader, "_lib", lambda: None)  # the JAX package's numpy path
    rng = np.random.default_rng(n)
    x, y = rng.normal(size=(n, 3)).astype(np.float32), rng.integers(0, 2, n)
    want = j_loader.BatchStream(x, y, batch_size=bs, shuffle=shuffle, seed=3)
    got = BatchStream(x, y, batch_size=bs, shuffle=shuffle, seed=3)
    for _ in range(7):  # across several wraps of the ring
        for a, b in zip(want.next(), got.next()):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
