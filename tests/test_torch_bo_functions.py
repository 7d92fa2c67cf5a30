"""The port's BO test functions and the malaria dataset against the JAX
package's: the eight negated functions at float64 to 1e-8 relative (on
random points in their bounds, at their canonical optima), their bounds
and optima; ``noisy`` draws from a generator; ``malaria_dataset`` arrays
equal bit for bit (synthetic field, the .npz branch and the .h5 branch on
both HDF5 fixtures). Also the new modules of the
slice exist and import nothing of JAX, optax or the JAX package."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.bayesopt import test_functions as jtf
from online_gp_tpu.data.malaria import malaria_dataset as jmalaria
from online_gp_torch.bayesopt import test_functions as ttf
from online_gp_torch.data import malaria_dataset

REPO = Path(__file__).resolve().parents[1]

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.mark.parametrize("name", jtf.TEST_FUNCTIONS)
@pytest.mark.parametrize("dim", [2, 3, 5])
def test_function_values_bounds_and_optima(name, dim):
    jf, tf = jtf.make_test_function(name, dim), ttf.make_test_function(name, dim, device="cpu")
    assert tf.name == jf.name and tf.dim == jf.dim
    np.testing.assert_array_equal(tf.bounds.numpy(), np.asarray(jf.bounds))
    assert tf.bounds.dtype == torch.float32
    if np.isnan(jf.optimal_value):
        assert np.isnan(tf.optimal_value)
    else:
        assert tf.optimal_value == jf.optimal_value
    rng = np.random.default_rng(dim)
    lo, hi = np.asarray(jf.bounds)[:, 0], np.asarray(jf.bounds)[:, 1]
    x = lo + (hi - lo) * rng.uniform(size=(64, dim))
    want = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_known_optima():
    # tests/bayesopt/test_bayesopt.py::test_known_optima on the port
    for name, argmin in [("Ackley", 0.0), ("Griewank", 0.0), ("Rastrigin", 0.0), ("Levy", 1.0), ("Rosenbrock", 1.0)]:
        fn = ttf.make_test_function(name, 3, device="cpu")
        assert abs(float(fn(torch.full((1, 3), argmin))[0])) < 1e-5
        assert float(fn(torch.full((1, 3), 2.5))[0]) < -0.5


def test_unknown_function_raises():
    with pytest.raises(ValueError, match="unknown test function"):
        ttf.make_test_function("Branin", 2, device="cpu")


def test_noisy_draws_from_the_generator():
    fn = ttf.make_test_function("Ackley", 3, device="cpu")
    x = torch.rand((5, 3), generator=torch.Generator().manual_seed(1)) * 10
    y1, lat1 = fn.noisy(x, 0.1, torch.Generator().manual_seed(7))
    y2, lat2 = fn.noisy(x, 0.1, torch.Generator().manual_seed(7))
    assert torch.equal(y1, y2) and torch.equal(lat1, fn(x)) and torch.equal(lat1, lat2)
    eps = torch.randn((5,), generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(y1, lat1 + 0.1 * eps)


@pytest.mark.parametrize("n, seed", [(2500, 0), (700, 3)])
def test_malaria_synthetic_matches_the_jax_package(n, seed):
    want, got = jmalaria(n=n, seed=seed), malaria_dataset(n=n, seed=seed)
    for field in ("x", "y", "y_var"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got.synthetic and want.synthetic


def test_malaria_npz_and_hdf5_branches(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "malaria.npz")
    np.savez(path, x=rng.uniform(3, 14, (300, 2)), y=rng.normal(size=300), y_var=rng.uniform(0.1, 1, 300))
    want, got = jmalaria(path), malaria_dataset(path)
    assert not got.synthetic
    for field in ("x", "y", "y_var"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    fixtures = REPO / "tests" / "fixtures"
    for name in ("tiny_malaria_plain.h5", "tiny_malaria_fixed.h5"):
        h5 = tmp_path / name
        h5.write_bytes((fixtures / name).read_bytes())
        want, got = jmalaria(str(h5)), malaria_dataset(str(h5))
        assert not got.synthetic
        for field in ("x", "y", "y_var"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


SLICE_MODULES = [
    "bayesopt/__init__.py", "bayesopt/test_functions.py", "bayesopt/optimize.py", "bayesopt/acquisitions.py",
    "bayesopt/loop.py", "bayesopt/active_learning.py", "bayesopt/mpv_osvgp.py", "experiments/config.py",
    "models/wiski_bayesopt.py", "data/malaria.py", "utils/lbfgs.py", "utils/checkpoint.py",
]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_no_jax(module):
    path = REPO / "online_gp_torch" / module
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "optax", "online_gp_tpu"), f"{path} imports {name}"
