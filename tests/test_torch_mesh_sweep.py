"""The port's ``run_sweep(mode="mesh")`` (``online_gp_torch/experiments/sweep.py``)
against the JAX package's, on the CPU.

- The regression sweep at ``tests/experiments/test_mesh_sweep.py::
  test_run_sweep_mesh_eye_stem``'s arguments (4 trials, friedman in 2-D,
  ``stem=eye``: no random init, so both packages start alike): every
  ``online_metrics`` column but ``step_time`` agrees with JAX's to 1e-4 of
  the column's largest magnitude, NaN where JAX has NaN, and so does each
  trial's ``test_rmse``.
- The ``wiski_gpd`` sweep at ``test_mesh_sweep_classification``'s
  arguments, the same way.
- The regression sweep on 2 spawned gloo ranks (the trials split over the
  ``dp`` mesh, rank 0 writing every trial's CSV) against the one-process
  run.
- The models ``mode=mesh`` does not run: ``localgp_regression`` raises JAX's
  ValueError (the baseline sweeps are ``test_torch_baseline_sweeps*.py``).
"""

import csv
import os

import numpy as np
import pytest
import torch

from online_gp_torch.experiments.sweep import run_sweep
from online_gp_torch.parallel.launch import spawn_ranks

RTOL = 1e-4  # of each column's largest magnitude: float32 trials (reached ~3e-5)
REG_ARGS = ["model=wiski_gp_regression", "dataset=friedman", "dataset.input_dim=2", "stem=eye", "stem.input_dim=2",
            "model.grid_size=8", "num_batch_epochs=5", "max_stream=32"]
CLS_ARGS = ["model=wiski_gpd", "dataset=banana", "stem=eye", "model.grid_size=8", "num_batch_epochs=10",
            "max_stream=48", "logging_freq=16"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors (the test workers
    share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _table(log_dir):
    with open(os.path.join(log_dir, "online_metrics.csv")) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, [{k: float(v) for k, v in r.items()} for r in reader]


def _assert_tables_match(got, want, test_keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["trial"] == w["trial"]
        for k in test_keys:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL)
        cols_g, rows_g = _table(g["log_dir"])
        cols_w, rows_w = _table(w["log_dir"])
        assert cols_g == cols_w and len(rows_g) == len(rows_w)
        for col in cols_w:
            if col == "step_time":
                continue
            a = np.array([r[col] for r in rows_g])
            b = np.array([r[col] for r in rows_w])
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=col)
            if np.isfinite(b).any():
                scale = max(np.nanmax(np.abs(b)), 1e-12)
                assert np.nanmax(np.abs(a - b)) <= RTOL * scale, (col, a, b)


@pytest.mark.parametrize("args,test_keys", [(REG_ARGS, ("test_rmse", "test_nll")), (CLS_ARGS, ("test_acc",))],
                         ids=["wiski_gp_regression", "wiski_gpd"])
def test_mesh_sweep_matches_jax(tmp_path, args, test_keys):
    from online_gp_tpu.experiments.sweep import run_sweep as jax_sweep

    want = jax_sweep(4, "mesh", args + [f"log_dir={tmp_path / 'jax'}"])
    got = run_sweep(4, "mesh", args + [f"log_dir={tmp_path / 'torch'}", "device=cpu"])
    _assert_tables_match(got, want, test_keys)
    assert len({round(r[test_keys[0]], 9) for r in got}) > 1  # distinct seeds, distinct trials


def _sweep_rank(rank, world, log_dir):
    torch.set_num_threads(1)
    out = run_sweep(4, "mesh", REG_ARGS + [f"log_dir={log_dir}", "device=cpu"])
    return out, sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []


def test_mesh_sweep_splits_the_trials_over_the_ranks(tmp_path):
    ranks = spawn_ranks(_sweep_rank, 2, (str(tmp_path / "ranks"),), store=str(tmp_path / "store"))
    one = run_sweep(4, "mesh", REG_ARGS + [f"log_dir={tmp_path / 'one'}", "device=cpu"])
    for out, _ in ranks:
        assert [r["test_rmse"] for r in out] == [r["test_rmse"] for r in ranks[0][0]]
    assert sorted(os.listdir(tmp_path / "ranks")) == [f"mesh-wiski_gp_regression-friedman-trial{t}" for t in range(4)]
    _assert_tables_match(ranks[0][0], one, ("test_rmse", "test_nll"))


def test_mesh_sweep_rejects_models_without_a_mesh_core(tmp_path):
    with pytest.raises(ValueError, match="mode=mesh"):
        run_sweep(2, "mesh", ["model=localgp_regression", f"log_dir={tmp_path}", "device=cpu"])
    with pytest.raises(ValueError, match="unknown sweep mode"):
        run_sweep(2, "grid", [f"log_dir={tmp_path}"])
