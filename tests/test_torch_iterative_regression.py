"""The port's dense ``OnlineSKIRegression`` in the iterative regime (m above
``max_cholesky_size``: the GP step on the CG/SLQ MLL) against the JAX
wrapper, at float64 inputs.

An 8 x 8 grid (m = 64) over ``max_cholesky_size=32``, a ``LinearStem``, the
stem, params and state carried across by ``convert``. Both run 3
``update()``s and a ``predict``. The port's probe function
(``api.regression.hyper_probes``) is replaced by one that returns JAX's
draws for ``fold_in(PRNGKey(7), num_data)``, so both steps see the same
probes. Tolerances as tests/test_torch_regression.py: rtol 1e-5 against
each quantity's largest entry (float32 params, float64 state).

Then the default configuration at 2-D ``grid_size=64`` (m = 4,096 >
2,048): ``update``, ``predict`` and ``fit`` run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.api import LinearStem as JLinear
from online_gp_tpu.api import OnlineSKIRegression as JRegression
from online_gp_tpu.config import SolverConfig as JConfig
from online_gp_tpu.data import sin_cos_dataset
from online_gp_torch import convert
from online_gp_torch.api import LinearStem, OnlineSKIRegression
from online_gp_torch.api import regression as treg
from online_gp_torch.config import SolverConfig
from online_gp_torch.models import wiski as tw

RTOL = 1e-5


@pytest.fixture
def one_intra_op_thread():
    """One intra-op thread for the parity test's small tensors (m = 64): on a
    machine the test workers share, OpenMP threads over them cost several
    times what they give. The m = 4,096 test keeps the default."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(want, got, what):
    want, got = np.asarray(_np(want), np.float64), np.asarray(_np(got), np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def jax_hyper_probes(num_data, num_outputs, m, dtype, device):
    """JAX's probes for the GP step at stream position num_data."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), jnp.uint32(num_data))
    slq, hutch = [], []
    for b in range(num_outputs):
        kb = jax.random.fold_in(key, b)
        slq.append([np.asarray(jax.random.rademacher(k, (m,), dtype=jnp.float64))
                    for k in jax.random.split(kb, tw.NUM_PROBES)])
        hutch.append(np.asarray(jax.random.rademacher(jax.random.fold_in(kb, 1), (m, tw.NUM_PROBES),
                                                      dtype=jnp.float64)))
    return tw.MllProbes(torch.tensor(np.asarray(slq), dtype=dtype, device=device),
                        torch.tensor(np.asarray(hutch), dtype=dtype, device=device))


def _carry_over(jr, tr):
    a = lambda v: None if v is None else np.asarray(v)
    convert.stem_from_numpy(tr.stem, jax.tree_util.tree_map(a, jr.stem_params),
                            jax.tree_util.tree_map(a, jr.stem_state), device="cpu")
    with torch.no_grad():
        for key in ("raw_lengthscale", "raw_outputscale"):
            tr.params["kernel"][key].copy_(torch.tensor(a(jr.params["kernel"][key])))
        tr.params["raw_second_noise"].copy_(torch.tensor(a(jr.params["raw_second_noise"])))
    s = jr.state
    tr.state = convert.state_from_numpy(a(s.wty), a(s.ydy), a(s.roots.mat), a(s.roots.root), a(s.roots.inv_root),
                                        a(s.d_logdet), a(s.num_data), device="cpu")


def _close_models(jr, tr, what):
    _close(jr.params["kernel"]["raw_lengthscale"], tr.params["kernel"]["raw_lengthscale"], f"{what}: lengthscale")
    _close(jr.params["kernel"]["raw_outputscale"], tr.params["kernel"]["raw_outputscale"], f"{what}: outputscale")
    _close(jr.params["raw_second_noise"], tr.params["raw_second_noise"], f"{what}: second noise")
    _close(np.asarray(jr.stem_params["lin"]["w"]).T, tr.stem.lin.weight, f"{what}: stem w")
    js, ts = jr.state, tr.state
    for name in ("wty", "ydy", "d_logdet"):
        _close(getattr(js, name), getattr(ts, name), f"{what}: {name}")
    _close(js.roots.root, ts.roots.root, f"{what}: root")


def test_iterative_wrapper_matches_jax(monkeypatch, one_intra_op_thread):
    """The default SolverConfig but for max_cholesky_size: dense K_uu
    products (use_toeplitz off; the Toeplitz ones are held to JAX in
    tests/test_torch_iterative_mll.py)."""
    monkeypatch.setattr(treg, "hyper_probes", jax_hyper_probes)
    tx, ty, *_ = sin_cos_dataset(n=200, seed=1)
    tx, ty = tx.astype(np.float64), ty[:, :1].astype(np.float64)
    kw = dict(lr=0.05, grid_size=8, grid_bound=1.0)
    jr = JRegression(JLinear(2, 2), tx[:40], ty[:40], cfg=JConfig(max_cholesky_size=32), **kw)
    tr = OnlineSKIRegression(LinearStem(2, 2), tx[:40], ty[:40], device="cpu", cfg=SolverConfig(max_cholesky_size=32),
                             **kw)
    assert tr.model.grid.num_points == 64 > tr.cfg.max_cholesky_size
    _carry_over(jr, tr)
    for i in range(40, 43):
        _close(jr.update(tx[i : i + 1], ty[i : i + 1]), tr.update(tx[i : i + 1], ty[i : i + 1]), f"update {i}")
        _close_models(jr, tr, f"after update {i}")
    for a, b in zip(jr.predict(tx[100:130]), tr.predict(tx[100:130])):
        _close(a, b, "predict")


def test_hyper_probes_depend_on_the_stream_position_only():
    a = treg.hyper_probes(40, 2, 64, torch.float64, "cpu")
    b = treg.hyper_probes(40, 2, 64, torch.float64, "cpu")
    c = treg.hyper_probes(41, 2, 64, torch.float64, "cpu")
    assert a.slq.shape == (2, tw.NUM_PROBES, 64) and a.hutch.shape == (2, 64, tw.NUM_PROBES)
    assert torch.equal(a.slq, b.slq) and torch.equal(a.hutch, b.hutch)
    assert not torch.equal(a.slq, c.slq)


def test_default_config_runs_the_iterative_regime_at_m4096():
    """OnlineSKIRegression(LinearStem(2, 2), x, y, grid_size=64) with the
    default SolverConfig: a dense-core model whose GP step is iterative."""
    tx, ty, *_ = sin_cos_dataset(n=200, seed=2)
    ty = ty[:, :1]
    reg = OnlineSKIRegression(LinearStem(2, 2), tx[:32], ty[:32], grid_size=64, device="cpu")
    assert type(reg) is OnlineSKIRegression and reg.model.grid.num_points == 4096 > reg.cfg.max_cholesky_size
    reg.cfg = reg.cfg.replace(max_cg_iterations=16)  # depth: the CG runs 16 iterations here, 256 by default
    s_loss, g_loss = reg.update(tx[32:33], ty[32:33])
    assert np.isfinite(s_loss) and np.isfinite(g_loss)
    mean, var = reg.predict(tx[100:104])
    assert mean.shape == var.shape == (4, 1) and bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    (rec,) = reg.fit(tx[:16], ty[:16], 1)
    assert np.isfinite(rec["train_loss"])
