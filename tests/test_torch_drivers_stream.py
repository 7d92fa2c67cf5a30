"""The port's fused regression trial and classification driver against
the JAX package's, on the CPU, with torch on one intra-op thread.

- ``regression_trial`` with ``stream_mode=fused`` (one prequential call,
  kernel K3 on the card, per 20-point logging segment, then a hyper step)
  at ``dataset=friedman dataset.input_dim=2 stem=eye``: the
  ``online_metrics`` header is JAX's, column for column, and every column
  but the two timings (``step_time``, ``points_per_sec``) agrees to rtol
  1e-4 of its largest value, the batch model's columns to 2e-3 (the
  float32 rounding that
  ``test_torch_drivers.py::test_batch_model_parts_from_jax_by_float32_rounding``
  shows).
- ``classification_trial`` at ``model=wiski_gpd dataset=banana stem=eye``
  (``tests/experiments/test_drivers.py``'s configuration): cumulative,
  batch and test accuracy and regret equal to JAX's, ``gp_loss`` to rtol
  1e-4, test accuracy above the JAX test's 0.7; the port's checkpoint
  resumes to 1e-6, and JAX's gives the JAX wrapper's accuracy.
"""

import csv
import os

import numpy as np
import pytest
import torch

from online_gp_tpu.experiments import config as j_config
from online_gp_tpu.experiments.classification import classification_trial as j_classification_trial
from online_gp_tpu.experiments.regression import regression_trial as j_regression_trial
from online_gp_torch.experiments import config
from online_gp_torch.experiments.classification import classification_trial
from online_gp_torch.experiments.common import build_model, load_dataset
from online_gp_torch.experiments.regression import regression_trial
from online_gp_torch.utils.checkpoint import load_wrapper

RTOL = 1e-4
BATCH_RTOL = 2e-3
BATCH_COLUMNS = ("batch_rmse", "batch_nll", "regret")
TIMINGS = ("step_time", "points_per_sec")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(log_dir):
    with open(os.path.join(log_dir, "online_metrics.csv")) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def _both(trial_j, trial_t, args, root):
    want = trial_j(j_config.parse_config(args + [f"log_dir={root / 'jax'}"]))
    cfg = config.parse_config(args + [f"log_dir={root / 'torch'}", "device=cpu"])
    return want, trial_t(cfg), cfg


def test_fused_regression_trial_matches_jax(tmp_path):
    args = ["model=wiski_gp_regression", "dataset=friedman", "dataset.input_dim=2", "stem=eye",
            "num_batch_epochs=3", "logging_freq=20", "max_stream=80", "stream_mode=fused"]
    want, got, _ = _both(j_regression_trial, regression_trial, args, tmp_path)
    want_cols, want_rows = _rows(want["log_dir"])
    got_cols, got_rows = _rows(got["log_dir"])
    assert got_cols == want_cols and "points_per_sec" in got_cols
    assert len(got_rows) == len(want_rows) == 4
    for col in want_cols:
        if col in TIMINGS:
            continue
        a = np.array([float(r[col]) for r in want_rows])
        b = np.array([float(r[col]) for r in got_rows])
        tol = BATCH_RTOL if col in BATCH_COLUMNS else RTOL
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol * max(np.max(np.abs(a)), 1e-12), err_msg=col)
    assert all(float(r["points_per_sec"]) > 0 for r in got_rows)
    np.testing.assert_allclose([got["test_rmse"], got["test_nll"]], [want["test_rmse"], want["test_nll"]], rtol=RTOL)


@pytest.fixture(scope="module")
def classification(tmp_path_factory):
    args = ["model=wiski_gpd", "dataset=banana", "stem=eye", "num_batch_epochs=15", "logging_freq=30",
            "max_stream=60"]
    return _both(j_classification_trial, classification_trial, args, tmp_path_factory.mktemp("cls"))


def test_classification_trial_matches_jax(classification):
    want, got, _ = classification
    want_cols, want_rows = _rows(want["log_dir"])
    got_cols, got_rows = _rows(got["log_dir"])
    assert got_cols == want_cols and len(got_rows) == len(want_rows) == 2
    for a, b in zip(want_rows, got_rows):
        for col in ("step", "stem_loss", "online_acc", "batch_acc", "regret", "test_acc"):
            assert float(b[col]) == float(a[col]), col
        np.testing.assert_allclose(float(b["gp_loss"]), float(a["gp_loss"]), rtol=RTOL)
    assert got["test_acc"] == want["test_acc"] >= 0.7


def _fresh(cfg):
    train_x, train_y, test_x, test_y = load_dataset(cfg)
    num_init = int(cfg["model"]["init_ratio"] * len(train_x))
    return build_model(cfg, train_x[:num_init], train_y[:num_init]), (train_x, train_y, test_x, test_y, num_init)


def test_classification_checkpoints_resume(classification):
    want, got, cfg = classification
    for out in (got, want):
        fresh, (train_x, train_y, test_x, test_y, num_init) = _fresh(cfg)
        load_wrapper(out["checkpoint"], fresh)
        assert abs(fresh.evaluate(test_x, test_y) - out["test_acc"]) < 1e-6
    sl, gl = fresh.update(train_x[num_init + 70 : num_init + 71], train_y[num_init + 70 : num_init + 71],
                          update_stem=False)
    assert np.isfinite(gl) and np.isfinite(fresh.evaluate(test_x, test_y))
