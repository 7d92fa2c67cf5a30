"""The port's fixed-noise driver and sequential sweep.

- ``fixed_noise_regression.run(arm="both")`` at the sizes of
  ``tests/experiments/test_drivers.py::test_fixed_noise_both_arms`` (6
  steps, 16 initial points, 32 test points, a grid of 8, chunks of 1, one
  MLL step a step, an evaluation every 3) on the synthetic malaria field,
  on the CPU beside JAX's: each arm's evaluation rows (points absorbed,
  test RMSE, MLL) agree to rtol 1e-4, the timing tables and the
  comparison CSV have JAX's columns. ``chunk_size=4`` and ``arm="exact"``
  alone run too; an unknown arm raises.
- ``run_sweep(2, "seq", ...)`` runs two regression trials with trial_id
  and seed 0 and 1, each the same as its own ``regression_trial``;
  ``mode="mesh"`` raises ``NotImplementedError`` (ROADMAP Queue 1 item 4)
  and an unknown mode ``ValueError``.
"""

import csv
import os

import numpy as np
import pytest
import torch

from online_gp_tpu.experiments.fixed_noise_regression import run as j_run
from online_gp_torch.experiments import fixed_noise_regression as fnr
from online_gp_torch.experiments.config import parse_config
from online_gp_torch.experiments.regression import regression_trial
from online_gp_torch.experiments.sweep import run_sweep

RTOL = 1e-4
SIZES = dict(num_steps=6, num_init=16, num_test=32, grid_size=8, chunk_size=1, mll_iters_per_step=1, eval_every=3,
             verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_fixed_noise_both_arms_match_jax(tmp_path):
    want = j_run(log_dir=str(tmp_path / "jax"), arm="both", **SIZES)
    got = fnr.run(log_dir=str(tmp_path / "torch"), arm="both", device="cpu", **SIZES)
    for arm in ("wiski", "exact"):
        assert got[arm]["steps"] == want[arm]["steps"] == 6
        assert got[arm]["points_absorbed"] == want[arm]["points_absorbed"]
        assert len(got[arm]["eval_rows"]) == len(want[arm]["eval_rows"]) == 2
        for a, b in zip(want[arm]["eval_rows"], got[arm]["eval_rows"]):
            assert (b["step"], b["num_data"]) == (a["step"], a["num_data"])
            np.testing.assert_allclose([b["test_rmse"], b["mll"]], [a["test_rmse"], a["mll"]], rtol=RTOL, err_msg=arm)
        table = os.path.join(got[arm]["log_dir"], "timing_metrics.csv")
        assert _header(table) == _header(os.path.join(want[arm]["log_dir"], "timing_metrics.csv"))
    assert _header(got["comparison_csv"]) == _header(want["comparison_csv"])
    assert np.isfinite(got["cond_speedup"]) and np.isfinite(got["mll_speedup"])


def test_fixed_noise_other_arms(tmp_path):
    sizes = dict(SIZES, num_steps=3)
    w = fnr.run(log_dir=str(tmp_path), arm="wiski", device="cpu", **dict(sizes, chunk_size=4))
    assert w["points_absorbed"] == 12 and w["eval_rows"][-1]["num_data"] == 16 + 12
    e = fnr.run(log_dir=str(tmp_path), arm="exact", device="cpu", **sizes)
    assert e["arm"] == "exact" and np.isfinite(e["eval_rows"][-1]["test_rmse"])
    with pytest.raises(ValueError, match="unknown arm"):
        fnr.run(log_dir=str(tmp_path), arm="nope", device="cpu", **sizes)


def test_run_sweep_seq(tmp_path):
    overrides = ["model=wiski_gp_regression", "dataset=friedman", "dataset.input_dim=2", "stem=eye",
                 "num_batch_epochs=2", "logging_freq=5", "max_stream=10", f"log_dir={tmp_path}", "device=cpu"]
    results = run_sweep(2, "seq", overrides)
    assert [os.path.basename(r["log_dir"]) for r in results] == [
        "wiski_gp_regression-friedman-trial0", "wiski_gp_regression-friedman-trial1"]
    assert results[0]["test_rmse"] != results[1]["test_rmse"]  # seeds 0 and 1
    again = regression_trial(parse_config(overrides[:-2] + [f"log_dir={tmp_path / 'again'}", "device=cpu",
                                                            "trial_id=1", "seed=1"]))
    assert again["test_rmse"] == results[1]["test_rmse"] and again["test_nll"] == results[1]["test_nll"]
    baseline = ["model=svgp_regression" if o.startswith("model=") else o for o in overrides]
    svgp = run_sweep(2, "mesh", baseline[:-2] + ["model.num_inducing=16", f"log_dir={tmp_path / 'svgp'}",
                                                  "device=cpu"])
    assert [os.path.basename(r["log_dir"]) for r in svgp] == [
        "mesh-svgp_regression-friedman-trial0", "mesh-svgp_regression-friedman-trial1"]
    assert all(np.isfinite(r["test_rmse"]) and np.isfinite(r["test_nll"]) for r in svgp)
    with pytest.raises(ValueError, match="unknown sweep mode"):
        run_sweep(2, "grid", overrides)
