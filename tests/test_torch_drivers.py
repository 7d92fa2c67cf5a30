"""The port's experiment config and regression driver against the JAX
package's (``online_gp_tpu/experiments``); the fused trial, the
classification driver, the fixed-noise driver and the sweep are in
test_torch_drivers_stream.py and test_torch_drivers_fixed_noise.py.

- ``parse_config`` returns JAX's dict for the argvs of
  ``tests/experiments/test_drivers.py`` and more, and raises JAX's errors;
  ``parse_cli_kwargs`` alike, and the BayesOpt entry points parse their
  arguments with it.
- ``regression_trial`` at ``model=wiski_gp_regression dataset=friedman
  dataset.input_dim=2 stem=eye`` (no random stem init), depth cut to 3
  batch epochs and 40 streamed points, on the CPU beside JAX's: the
  ``online_metrics`` header is JAX's, column for column, and every column
  but ``step_time`` agrees to rtol 1e-4 of the column's largest value
  (reached: ~2e-5), except the batch model's columns (``batch_rmse``,
  ``batch_nll`` and ``regret``, which subtracts ``batch_rmse``), held to
  2e-3 (reached: ~1.5e-3). Their per-step terms are the batch model's
  predictions on single points, from caches over all 3,600 training
  points at float32: there the two packages part by the float32 error
  each of them makes, as
  ``test_batch_model_parts_from_jax_by_float32_rounding`` shows against
  a float64 computation (ROADMAP, "Reference behaviour").
- The JAX driver's ``final_state`` loads into the port's wrapper and
  reproduces the JAX wrapper's test RMSE and NLL; the port's own resumes
  to 1e-6 and keeps streaming.
- The fused prequential engine equals the per-step evaluate-then-update
  loop with the hypers frozen (``test_drivers.py:166-208``).
"""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from online_gp_tpu.api import IdentityStem as JIdentity
from online_gp_tpu.api import OnlineSKIRegression as JRegression
from online_gp_tpu.experiments import config as j_config
from online_gp_tpu.experiments.regression import regression_trial as j_regression_trial
from online_gp_torch.api import IdentityStem, OnlineSKIRegression
from online_gp_torch.bayesopt import active_learning, loop, mpv_osvgp
from online_gp_torch.data import streaming_friedman
from online_gp_torch.experiments import config
from online_gp_torch.experiments.common import build_model, load_dataset
from online_gp_torch.experiments.regression import regression_trial
from online_gp_torch.models.wiski import WiskiModel, wiski_init, wiski_predict
from online_gp_torch.ops.grid import Grid
from online_gp_torch.utils.checkpoint import load_wrapper

RTOL = 1e-4
BATCH_RTOL = 2e-3
BATCH_COLUMNS = ("batch_rmse", "batch_nll", "regret")
ARGS = ["model=wiski_gp_regression", "dataset=friedman", "dataset.input_dim=2", "stem=eye",
        "num_batch_epochs=3", "logging_freq=10", "max_stream=40"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("argv", [
    [],
    ["model=svgp_regression", "dataset=powerplant", "stem=mlp", "model.lr=0.003", "batch_size=8",
     "solver.cg_tolerance=0.1"],
    ["model=wiski_gp_regression", "dataset=friedman", "stem=linear", "num_batch_epochs=10", "logging_freq=20",
     "max_stream=60", "log_dir=/x", "dataset.input_dim=2"],
    ["model=wiski_gpd", "dataset=banana", "stem=eye", "device=cpu", "logger.name=s3", "logger.bucket_root=r"],
    ["model=sgpr_regression", "dataset=elevators", "stem.feature_dim=3", "pretrain_stem.enabled=true",
     "max_stream=none", "stream_mode=fused", "subsample_ratio=0.5"],
    ["model=svgp_classification", "dataset=criteo", "batch_size=4", "model.variational_mode=grad"],
    ["model=exact_gpd", "dataset=svmguide1", "stem=mlp", "stem.hidden_dims=32,16", "seed=3", "trial_id=3"],
])
def test_parse_config_matches_jax(argv):
    got, want = config.parse_config(argv), j_config.parse_config(argv)
    assert got == want
    assert repr(got) == repr(want)  # the same types too (1 is not 1.0 or True)


@pytest.mark.parametrize("argv,match", [
    (["model=nope"], "unknown model"), (["dataset=nope"], "unknown dataset"), (["stem=nope"], "unknown stem"),
    (["--flag"], "key=value"),
])
def test_parse_config_raises_as_jax(argv, match):
    with pytest.raises(ValueError, match=match) as got:
        config.parse_config(argv)
    with pytest.raises(ValueError) as want:
        j_config.parse_config(argv)
    assert str(got.value) == str(want.value)


def test_parse_cli_kwargs_matches_jax():
    argv = ["num_steps=5", "lr=1e-3", "verbose=false", "data_path=none", "arm=both", "x=1.5", "flag=True"]
    got, want = config.parse_cli_kwargs(argv), j_config.parse_cli_kwargs(argv)
    assert repr(got) == repr(want)
    with pytest.raises(ValueError, match="key=value"):
        config.parse_cli_kwargs(["oops"])


@pytest.mark.parametrize("module,run", [(loop, "run_bayesopt"), (active_learning, "run_active_learning"),
                                        (mpv_osvgp, "run_mpv_osvgp")])
def test_bayesopt_entry_points_parse_with_the_config_grammar(monkeypatch, module, run):
    seen = {}
    monkeypatch.setattr(module, run, lambda **kw: seen.update(kw) or {"best_per_step": [], "records": [None]})
    monkeypatch.setattr(sys, "argv", ["prog", "num_steps=3", "verbose=false", "acqf=ei"])
    module.main()
    assert seen == config.parse_cli_kwargs(["num_steps=3", "verbose=false", "acqf=ei"])


def _rows(log_dir, table="online_metrics"):
    with open(os.path.join(log_dir, f"{table}.csv")) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def compare_online_metrics(want_dir, got_dir):
    """The header column for column; each column but step_time to its
    tolerance against the column's largest magnitude."""
    want_cols, want = _rows(want_dir)
    got_cols, got = _rows(got_dir)
    assert got_cols == want_cols
    assert len(got) == len(want) >= 2
    for col in want_cols:
        if col == "step_time":
            continue
        a = np.array([float(r[col]) for r in want])
        b = np.array([float(r[col]) for r in got])
        tol = BATCH_RTOL if col in BATCH_COLUMNS else RTOL
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol * max(np.max(np.abs(a)), 1e-12), err_msg=col)


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    root = tmp_path_factory.mktemp("drivers")
    want = j_regression_trial(j_config.parse_config(ARGS + [f"log_dir={root / 'jax'}"]))
    cfg = config.parse_config(ARGS + [f"log_dir={root / 'torch'}", "device=cpu"])
    got = regression_trial(cfg)
    return want, got, cfg


def test_regression_driver_matches_jax(trials):
    want, got, _ = trials
    compare_online_metrics(want["log_dir"], got["log_dir"])
    for key in ("test_rmse", "test_nll"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    for table in ("batch_metrics", "pretrain_metrics"):
        assert _rows(got["log_dir"], table)[0] == _rows(want["log_dir"], table)[0]
    got_cfg, want_cfg = (json.load(open(os.path.join(out["log_dir"], "config.json"))) for out in (got, want))
    assert got_cfg.pop("device") == "cpu"
    got_cfg["log_dir"] = want_cfg["log_dir"]
    assert got_cfg == want_cfg


def _fresh(cfg):
    train_x, train_y, test_x, test_y = load_dataset(cfg)
    num_init = int(cfg["model"]["init_ratio"] * len(train_x))
    return build_model(cfg, train_x[:num_init], train_y[:num_init]), (train_x, train_y, test_x, test_y, num_init)


def test_jax_checkpoint_loads_in_the_port(trials):
    want, _, cfg = trials
    fresh, (_, _, test_x, test_y, _) = _fresh(cfg)
    load_wrapper(want["checkpoint"], fresh)
    assert fresh.state.num_data == 180 + 40 and fresh.state.wty.dtype == torch.float32
    rmse, nll = fresh.evaluate(test_x, test_y)
    np.testing.assert_allclose([rmse, nll], [want["test_rmse"], want["test_nll"]], rtol=1e-5)


def test_port_checkpoint_resumes(trials):
    _, got, cfg = trials
    fresh, (train_x, train_y, test_x, test_y, num_init) = _fresh(cfg)
    load_wrapper(got["checkpoint"], fresh)
    rmse, nll = fresh.evaluate(test_x, test_y)
    assert abs(rmse - got["test_rmse"]) < 1e-6 and abs(nll - got["test_nll"]) < 1e-6
    n_before = fresh.state.num_data
    sl, gl = fresh.update(train_x[num_init + 40 : num_init + 44], train_y[num_init + 40 : num_init + 44],
                          update_stem=False)
    assert np.isfinite(sl) and np.isfinite(gl)
    assert fresh.state.num_data == n_before + 4
    assert np.isfinite(fresh.evaluate(test_x, test_y)[0])


def test_batch_model_parts_from_jax_by_float32_rounding():
    """The batch model of the driver (no fit: the caches at the initial
    hypers over all 3,600 training points) predicts single stream points
    as JAX's does to the float32 error each package makes: against a
    float64 computation of the same model, the port's error is no larger
    than twice JAX's, and the two part by no more than twice JAX's own
    error. The online model, on 180 points, parts far less."""
    tx, ty, _, _ = streaming_friedman(n=4000, seed=0, num_dims=2)
    q = tx[180:260]
    jr = JRegression(JIdentity(2), tx, ty, grid_size=16, lr=0.01)
    tr = OnlineSKIRegression(IdentityStem(2), tx, ty, grid_size=16, lr=0.01, device="cpu")
    jm, tm = np.asarray(jr.predict(q)[0], np.float64), tr.predict(q)[0].double().numpy()
    grid = Grid.create([(-1.1, 1.1)] * 2, 16, dtype=torch.float64, device="cpu")
    model = WiskiModel(tr.model.kernel, grid, num_outputs=1, learn_additional_noise=True)
    params = {"kernel": {k: v.detach().double() for k, v in tr.params["kernel"].items()},
              "raw_second_noise": tr.params["raw_second_noise"].detach().double()}
    x64, y64 = torch.from_numpy(tx.astype(np.float64)), torch.from_numpy(ty.astype(np.float64))
    with torch.no_grad():
        state = wiski_init(model, x64, y64, torch.ones_like(y64))
        ref = wiski_predict(model, params, state, torch.from_numpy(q.astype(np.float64)))[0].T.numpy()
    jax_err, port_err, parting = (float(np.max(np.abs(a - b))) for a, b in ((jm, ref), (tm, ref), (jm, tm)))
    assert jax_err > 1e-5  # float32 caches over 3,600 points: far above float32's 6e-8
    assert port_err <= 2 * jax_err and parting <= 2 * jax_err, (jax_err, port_err, parting)
    jr0 = JRegression(JIdentity(2), tx[:180], ty[:180], grid_size=16, lr=0.01)
    tr0 = OnlineSKIRegression(IdentityStem(2), tx[:180], ty[:180], grid_size=16, lr=0.01, device="cpu")
    assert np.max(np.abs(np.asarray(jr0.predict(q)[0]) - tr0.predict(q)[0].numpy())) < parting / 4


def test_fused_stream_matches_per_step_loop():
    """With hyper/stem movement disabled, the fused prequential engine's
    per-point moments equal the per-point predict -> condition loop's; then
    hyper_step moves the hypers without conditioning."""
    rng = np.random.default_rng(0)
    init_x = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    init_y = np.sin(3 * init_x[:, :1]) * np.cos(2 * init_x[:, 1:])
    xs = rng.uniform(-1, 1, (24, 2)).astype(np.float32)
    ys = (np.sin(3 * xs[:, :1]) * np.cos(2 * xs[:, 1:])).astype(np.float32)

    def fresh():
        return OnlineSKIRegression(IdentityStem(2), init_x, init_y, grid_size=8, seed=0, device="cpu")

    a = fresh()
    means_a, vars_a = [], []
    for i in range(len(xs)):
        m, v = a.predict(xs[i : i + 1])
        means_a.append(m[0].numpy())
        vars_a.append(v[0].numpy())
        a.update(xs[i : i + 1], ys[i : i + 1], update_stem=False, update_gp=False)
    b = fresh()
    means_b, vars_b = b.prequential(xs, ys)
    np.testing.assert_allclose(means_b.numpy(), np.stack(means_a), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(vars_b.numpy(), np.stack(vars_a), rtol=2e-4, atol=2e-5)
    assert a.state.num_data == b.state.num_data
    n_before = b.state.num_data
    sl, gl = b.hyper_step(xs[-4:], ys[-4:], update_stem=False)
    assert np.isfinite(gl) and b.state.num_data == n_before
