"""The plain reference agrees with the port's CPU path: its pieces at
float64, and every cell end to end at a tiny size."""

import math
import time

import numpy as np
import pytest
import torch

from gpbench import check, spec
from gpbench import reference as R
from gpbench import run
from gpbench.traffic import Hypers, Record, Stream, draw_hypers, make_inputs, run_request
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
    data = R.absorb(grid, R.empty(grid.num_points, 1, torch.float64, "cpu"), t(x0), t(y0))
    eps = R.jitter(data.A[0], config["root_jitter"])
    data = R.absorb(grid, data, t(xs), t(ys))
    K = R.kuu(grid, hypers.lengthscale, hypers.outputscale, torch.float64, "cpu") / hypers.noise
    L = reg.state.roots.root[0]
    A_eps = data.A[0] + eps * torch.eye(grid.num_points, dtype=torch.float64)
    torch.testing.assert_close(L @ L.T, A_eps, rtol=0, atol=1e-6 * float(A_eps.abs().max()))
    em, ev = R.predict(grid, R.posterior(K, R.root(data.A[0], eps), data.wty[0]), t(q), hypers.noise)
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


def test_dirichlet_by_hand():
    # alpha_eps = 0.01: a point's own class alpha 1.01, noise log(1 / 1.01 + 1)
    # = log 1.990099..., the other alpha 0.01, noise log 101
    targets, noises = R.dirichlet(torch.tensor([1, 0, 1]), 2, 0.01)
    own, other = math.log(1.0 / 1.01 + 1.0), math.log(101.0)
    want_noise = torch.tensor([[other, own], [own, other], [other, own]], dtype=torch.float64)
    torch.testing.assert_close(noises, want_noise, rtol=1e-15, atol=0)
    want = torch.log(torch.tensor([[0.01, 1.01], [1.01, 0.01], [0.01, 1.01]], dtype=torch.float64)) - 0.5 * want_noise
    torch.testing.assert_close(targets, want, rtol=1e-15, atol=0)
    assert math.isclose(own, math.log(1.990099009900990), rel_tol=1e-15)


def _one_output_by_todays_formulas(config, hypers, inputs, record, fin, queries, control):
    """The check's numbers and the reference's W y and root as the harness
    computed them while it took one output at unit noise, written out."""
    dtype = torch.float32 if control else torch.float64
    grid = R.Grid.create(config["grid_bounds"], config["wrapper"]["grid_size"], config["grid_pad"])
    m = grid.num_points
    t = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731

    def absorb(A, wty, x, y):
        for s in range(0, x.shape[0], 4096):
            idx, w = R.interp(grid, x[s:s + 4096])
            W = R.dense_w(idx, w, m)
            A = A + W @ W.T
            wty = wty + W @ y[s:s + 4096]
        return A, wty

    with R.precision(control):
        A, wty = absorb(torch.zeros((m, m), dtype=dtype), torch.zeros(m, dtype=dtype), t(inputs.seed_x),
                        t(inputs.seed_y[:, 0]))
        eps = R.jitter(A, config["root_jitter"])
        roots = R.root_pair(A, eps) if control else None
        for steps in record.requests:
            for done in steps:
                x = t(inputs.pool_x[done.start:done.start + done.n])
                A, wty = absorb(A, wty, x, t(inputs.pool_y[done.start:done.start + done.n, 0]))
                for b in range(0, x.shape[0], 256) if control else ():
                    idx, w = R.interp(grid, x[b:b + 256])
                    roots = R.root_update(*roots, R.dense_w(idx, w, m))
        A_eps = A + eps * torch.eye(m, dtype=dtype)
        root = roots[0] if control else R.root(A, eps)
    if control:
        return None, wty, root
    K = R.kuu(grid, hypers.lengthscale, hypers.outputscale, dtype, "cpu") / hypers.noise
    L = fin.root[0].double()
    out = {"roots": check._rel(L @ L.T, A_eps), "wty": check._rel(fin.wty[0], wty)}
    with R.precision(False):
        post = R.posterior(K, L, fin.wty[0].double())
        ref_post = R.posterior(K, root, wty)
        out["state_mean"], out["state_var"] = check.moments(*R.predict(grid, post, queries, hypers.noise),
                                                            *R.predict(grid, ref_post, queries, hypers.noise))
    return out, wty, root


@pytest.mark.parametrize("seed", [2**31 + 7, 2**31 + 8, 11])
@pytest.mark.parametrize("cell", CELLS)
def test_one_output_at_unit_noise_is_todays_formulas(cell, seed):
    """Bit for bit: the per-output replay and judge at B = 1 without noises,
    the control's replay too, against the single-output formulas."""
    c = small_cell(cell)
    config, mix = c.config, c.mix
    inputs = make_inputs(mix, config["input_dim"], seed, "cpu")
    hypers = draw_hypers(config, seed)
    system = spec.wrapper(config)
    reg = system.make(config, hypers, inputs.seed_x, inputs.seed_y, "cpu")
    record, stream = Record(), Stream(inputs)
    for _ in range(3):
        run_request(reg, mix, stream, record)
    fin = system.final(reg)
    queries = run.check_queries(config, mix, seed, "cpu")
    truth, A_eps, K = check.replay(config, hypers, inputs, record, [], "cpu")
    numbers = check.judge(check.program_produced(fin, record, []), truth, A_eps, K, config, hypers, queries, record)
    want, wty, root = _one_output_by_todays_formulas(config, hypers, inputs, record, fin, queries, False)
    assert numbers == want
    assert torch.equal(truth.wty[0], wty) and torch.equal(truth.root[0], root)
    ctrl, _, _ = check.replay(config, hypers, inputs, record, [], "cpu", control=True)
    _, wty, root = _one_output_by_todays_formulas(config, hypers, inputs, record, fin, queries, True)
    assert torch.equal(ctrl.wty[0], wty) and torch.equal(ctrl.root[0], root)
