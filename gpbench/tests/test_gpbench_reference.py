"""The plain reference agrees with the port's CPU path: its pieces at
float64, and every cell end to end at a tiny size."""

import math
import time

import numpy as np
import pytest
import torch

from gpbench import reference as R
from gpbench import run, spec
from gpbench.traffic import Hypers
from gpbench.tests.small import CELLS, small_cell


def test_interp_and_kuu_are_the_ports():
    from online_gp_torch.kernels.base import make_kernel
    from online_gp_torch.kernels.grid_kernel import grid_kuu_dense
    from online_gp_torch.ops.grid import Grid
    from online_gp_torch.ops.interp import interp_coeffs

    ref = R.Grid.create([(-1.1, 1.1)] * 2, 12)
    port = Grid.create([(-1.1, 1.1)] * 2, 12, dtype=torch.float64, device="cpu")
    x = torch.rand(500, 2, dtype=torch.float64) * 2.2 - 1.1
    i_r, w_r = R.interp(ref, x)
    i_p, w_p = interp_coeffs(port, x)
    assert torch.equal(i_r, i_p)
    torch.testing.assert_close(w_r, w_p, rtol=0, atol=1e-13)
    kernel = make_kernel("rbf")
    params = {"raw_lengthscale": torch.log(torch.tensor([[0.3, 0.45]], dtype=torch.float64)),
              "raw_outputscale": torch.log(torch.tensor([1.7], dtype=torch.float64))}
    K_p = grid_kuu_dense(kernel, params, port)[0]
    K_r = R.kuu(ref, (0.3, 0.45), 1.7, torch.float64, "cpu")
    torch.testing.assert_close(K_r, K_p, rtol=1e-12, atol=1e-12)


def test_the_wrapper_at_float64_is_the_reference():
    """Streams of float64 points through the port's wrapper (float32
    parameters, a float32 grid: the stencils part at 1e-7) against the
    reference: the roots, and what predict returns from them."""
    from gpbench.wrappers import online_ski_regression as system

    cell = small_cell("grid30-absorb", grid=12)
    config = cell.config
    hypers = Hypers((math.exp(-1.0), math.exp(-0.75)), math.exp(0.25), math.exp(-4.0))
    rng = np.random.default_rng(0)
    x0, xs, q = (rng.uniform(-1, 1, (n, 2)) for n in (256, 700, 300))
    y0, ys = (np.sin(3 * a[:, :1]) + 0.1 * rng.standard_normal((len(a), 1)) for a in (x0, xs))
    reg = system.make(config, hypers, x0, y0, "cpu")
    reg.absorb(xs[:300], ys[:300])
    reg.absorb(xs[300:], ys[300:])
    qm, qv = reg.predict(q)

    grid = R.Grid.create(config["grid_bounds"], 12, config["grid_pad"])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    data = R.absorb(grid, R.empty(grid.num_points, torch.float64, "cpu"), t(x0), t(y0[:, 0]))
    eps = R.jitter(data.A, config["root_jitter"])
    data = R.absorb(grid, data, t(xs), t(ys[:, 0]))
    K = R.kuu(grid, hypers.lengthscale, hypers.outputscale, torch.float64, "cpu") / hypers.noise
    L = reg.state.roots.root[0]
    A_eps = data.A + eps * torch.eye(grid.num_points, dtype=torch.float64)
    torch.testing.assert_close(L @ L.T, A_eps, rtol=0, atol=1e-6 * float(A_eps.abs().max()))
    em, ev = R.predict(grid, R.posterior(K, R.root(data.A, eps), data.wty), t(q), hypers.noise)
    torch.testing.assert_close(qm[:, 0], em, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(qv[:, 0], ev, rtol=1e-5, atol=0)


# float32 on the CPU against the float64 reference at a tiny size: the
# plain versions' rounding. The cells' limits are set at their own sizes
# on the card, where more points a grid node average the rounding out.
TINY = {"roots": 1e-5, "wty": 1e-5, "state_mean": 1e-3, "state_var": 1e-5}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_end_to_end_agrees_with_the_reference(cell):
    out = run.run_cell(small_cell(cell), 2**31 + 12345, 1.0, False, "cpu", time.perf_counter())
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(spec.load_cell(cell).limits) and set(out["numbers"]) >= set(out["checks"])
    for name, value in out["numbers"].items():
        assert value <= TINY[name], (cell, name, value)
