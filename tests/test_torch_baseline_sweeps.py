"""The port's baseline mesh sweeps (``online_gp_torch/experiments/sweep.py``:
``mesh_svgp_sweep``, ``mesh_svgp_classification_sweep``, ``mesh_sgpr_sweep``)
against the JAX package's, on the CPU.

- The O-SVGP regression sweep at ``tests/experiments/test_mesh_sweep.py``'s
  arguments (4 trials, 16 inducing points, ``stem=eye``, friedman in 2-D),
  with the port's ``trial_inducing_points`` replaced by JAX's draws
  (``split(split(PRNGKey(seed), T)[t])``'s second key, U(-1, 1)), against
  the JAX package's sweep (:func:`assert_sweeps_match`); JAX's bars (the
  trials distinct).
- The same sweep on 2 spawned gloo ranks (trials split over the ``dp``
  mesh) against the one-process run.

``test_torch_baseline_sweeps_cls.py`` holds the classifier and the O-SGPR
sweep. The JAX sweeps run once per module. The spawned ranks import this
module, so JAX is imported inside the tests only.
"""

import os

import numpy as np
import pytest
import torch

import online_gp_torch.experiments.sweep as sweep
from online_gp_torch.experiments.sweep import run_sweep
from online_gp_torch.parallel.launch import spawn_ranks
from tests.test_torch_mesh_sweep import _assert_tables_match, _table

T = 4
# of each column's largest magnitude (module docstring of assert_sweeps_match)
F64_TOL, F32_TOL = 2e-3, 1e-2
SVGP_ARGS = ["model=svgp_regression", "model.num_inducing=16", "model.num_update_steps=2", "dataset=friedman",
             "dataset.input_dim=2", "stem=eye", "stem.input_dim=2", "num_batch_epochs=10", "max_stream=32",
             "batch_size=4", "logging_freq=4"]
CLS_ARGS = ["model=svgp_classification", "model.num_inducing=16", "model.num_update_steps=2", "dataset=banana",
            "stem=eye", "num_batch_epochs=20", "max_stream=32", "batch_size=4", "logging_freq=2"]
SGPR_ARGS = ["model=sgpr_regression", "model.num_inducing=16", "model.num_update_steps=2", "model.rebase_every=3",
             "dataset=friedman", "dataset.input_dim=2", "stem=eye", "stem.input_dim=2", "num_batch_epochs=10",
             "max_stream=32", "batch_size=4", "logging_freq=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors (the test workers
    share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_inducing_points(cfg, trials, num_inducing, dim, device):
    """The JAX sweeps' draws: trial t's inducing points from the second key
    of ``split(split(PRNGKey(seed), T)[t])``."""
    import jax

    keys = jax.random.split(jax.random.PRNGKey(cfg["seed"]), T)
    zs = [np.asarray(jax.random.uniform(jax.random.split(keys[t])[1], (num_inducing, dim), minval=-1.0,
                                        maxval=1.0)) for t in trials]
    return torch.as_tensor(np.stack(zs), device=device)


def _columns(results, test_keys):
    """{column: (trials, rows)} of the trials' ``online_metrics`` tables
    (``step_time`` left out) and {test metric: (trials,)}."""
    cols = {}
    for r in results:
        names, rows = _table(r["log_dir"])
        for c in names:
            if c != "step_time":
                cols.setdefault(c, []).append([row[c] for row in rows])
    return {k: np.array(v) for k, v in cols.items()}, {k: np.array([r[k] for r in results]) for k in test_keys}


def _assert_close(got, want, tol, what):
    for k, b in want.items():
        a = got[k]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: {k}")
        if np.isfinite(b).any():
            scale = max(np.nanmax(np.abs(b)), 1e-12)
            assert np.nanmax(np.abs(a - b)) <= tol * scale, (what, k, a, b)


def assert_sweeps_match(tmp_path, monkeypatch, args, test_keys, want):
    """The port's sweep against JAX's float32 results ``want``, from JAX's
    inducing draws.

    The trials run at float32, and the baselines' Adam steps through
    covariances floored at 1e-5 I amplify float32 rounding, each package's
    its own (an O-SVGP trial's float32 noise parts from a float64 run of it
    by up to 4.8e-3 of its scale in the port, 3.5e-4 in JAX). So the
    semantics are held at float64: the port's float64 run of the same
    trials (the stacked data cast up, every tensor following it) agrees
    with JAX's float32 run to ``F64_TOL`` of each column's largest
    magnitude, NaN where JAX has NaN (reached 9.5e-4), and the port's
    float32 run with its float64 run to ``F32_TOL`` (reached 4.8e-3);
    each trial's test metric likewise. Returns the float32 results."""
    monkeypatch.setattr(sweep, "trial_inducing_points", jax_inducing_points)
    got = run_sweep(T, "mesh", args + [f"log_dir={tmp_path / 'f32'}", "device=cpu"])
    stack = sweep._stack_trial_data
    monkeypatch.setattr(sweep, "_stack_trial_data", lambda *a: tuple(
        x.astype(np.float64) if x.dtype == np.float32 else x for x in stack(*a)))
    got64 = run_sweep(T, "mesh", args + [f"log_dir={tmp_path / 'f64'}", "device=cpu"])
    assert [r["trial"] for r in got] == [r["trial"] for r in want] == list(range(T))
    (c32, t32), (c64, t64), (cj, tj) = (_columns(r, test_keys) for r in (got, got64, want))
    assert list(c32) == list(cj)
    _assert_close(c64, cj, F64_TOL, "float64 port against JAX")
    _assert_close(t64, tj, F64_TOL, "float64 port against JAX")
    _assert_close(c32, c64, F32_TOL, "float32 port against float64 port")
    _assert_close(t32, t64, F32_TOL, "float32 port against float64 port")
    return got


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    from online_gp_tpu.experiments.sweep import run_sweep as jax_sweep

    return jax_sweep(T, "mesh", SVGP_ARGS + [f"log_dir={tmp_path_factory.mktemp('jax')}"])


def test_svgp_mesh_sweep_matches_jax(tmp_path, monkeypatch, jax_run):
    got = assert_sweeps_match(tmp_path, monkeypatch, SVGP_ARGS, ("test_rmse", "test_nll"), jax_run)
    assert len({round(r["test_rmse"], 9) for r in got}) > 1


def _sweep_rank(rank, world, log_dir):
    out = run_sweep(T, "mesh", SVGP_ARGS + [f"log_dir={log_dir}", "device=cpu"])
    return out, sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []


def test_baseline_mesh_sweep_splits_the_trials_over_the_ranks(tmp_path):
    ranks = spawn_ranks(_sweep_rank, 2, (str(tmp_path / "ranks"),), store=str(tmp_path / "store"))
    one = run_sweep(T, "mesh", SVGP_ARGS + [f"log_dir={tmp_path / 'one'}", "device=cpu"])
    for out, _ in ranks:
        assert [r["test_rmse"] for r in out] == [r["test_rmse"] for r in ranks[0][0]]
    assert ranks[0][1] == [f"mesh-svgp_regression-friedman-trial{t}" for t in range(T)]
    _assert_tables_match(ranks[0][0], one, ("test_rmse", "test_nll"))
    assert len({round(r["test_rmse"], 9) for r in one}) == T  # each trial its own seed and inducing points
