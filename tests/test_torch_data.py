"""The port's own copies of the data helpers against the JAX package's:
``banana_dataset`` array for array (the same bits and dtypes), and
``minmax_scale`` and ``train_test_split`` on their own."""

import numpy as np
import pytest

from online_gp_tpu.data import banana_dataset as j_banana
from online_gp_tpu.data.preprocessing import minmax_scale as j_minmax
from online_gp_tpu.data.preprocessing import train_test_split as j_split
from online_gp_torch.data import banana_dataset, minmax_scale, train_test_split


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
