"""The port's O-SVGP classification and O-SGPR mesh sweeps
(``online_gp_torch/experiments/sweep.py``) against the JAX package's, on
the CPU, at ``tests/experiments/test_mesh_sweep.py``'s arguments (4 trials,
16 inducing points, ``stem=eye``, banana or friedman in 2-D), from JAX's
inducing draws, by ``test_torch_baseline_sweeps.assert_sweeps_match``; and
JAX's own bars: at least one classifier trial reaches accuracy 0.6, and
SGPR's ``gp_loss`` is finite on the rebase chunks (every third) and NaN on
the others, the trials distinct. The JAX sweeps run once per module. And
each trial's results are bitwise the same whether a rank runs 4 trials or
2 (the split over ranks), for all three sweeps.
"""

import numpy as np
import pytest
import torch

import online_gp_torch.experiments.sweep as sweep
from online_gp_torch.experiments.config import parse_config
from tests.test_torch_baseline_sweeps import CLS_ARGS, SGPR_ARGS, SVGP_ARGS, T, _table, assert_sweeps_match

CASES = {"svgp_classification": (CLS_ARGS, ("test_acc",)), "sgpr_regression": (SGPR_ARGS, ("test_rmse", "test_nll"))}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    from online_gp_tpu.experiments.sweep import run_sweep as jax_sweep

    root = tmp_path_factory.mktemp("jax")
    return {name: jax_sweep(T, "mesh", args + [f"log_dir={root / name}"]) for name, (args, _) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_baseline_mesh_sweep_matches_jax(tmp_path, monkeypatch, jax_runs, name):
    args, test_keys = CASES[name]
    got = assert_sweeps_match(tmp_path, monkeypatch, args, test_keys, jax_runs[name])
    if name == "svgp_classification":
        assert max(r["test_acc"] for r in got) >= 0.6
    else:
        for r in got:
            losses = [row["gp_loss"] for row in _table(r["log_dir"])[1]]
            assert [bool(np.isfinite(v)) for v in losses] == [(c + 1) % 3 == 0 for c in range(len(losses))]
        assert len({round(r["test_rmse"], 9) for r in got}) > 1


@pytest.mark.parametrize("name", ["svgp_regression", "svgp_classification", "sgpr_regression"])
def test_trials_do_not_depend_on_the_split(name):
    args = dict(svgp_regression=SVGP_ARGS, svgp_classification=CLS_ARGS, sgpr_regression=SGPR_ARGS)[name]
    cfg = parse_config(args + ["device=cpu"])
    classification = name == "svgp_classification"
    data = sweep._stack_trial_data(cfg, T, "labels_f" if classification else "single")
    trial_fn = sweep._sgpr_trial if name == "sgpr_regression" else (
        lambda *a: sweep._svgp_trial(*a, classification=classification))
    run = sweep._baseline_runner(trial_fn, classification)
    part = lambda lo, hi: run(cfg, range(lo, hi), *(torch.as_tensor(a[lo:hi]) for a in data), "cpu")
    whole, halves = part(0, T), [part(0, T // 2), part(T // 2, T)]
    for got, want in ((whole[0], {k: torch.cat([h[0][k] for h in halves]) for k in whole[0]}),
                      (whole[1], {k: torch.cat([h[1][k] for h in halves]) for k in whole[1]})):
        for k in want:
            assert torch.equal(torch.isnan(got[k]), torch.isnan(want[k])), k
            assert torch.equal(torch.nan_to_num(got[k]), torch.nan_to_num(want[k])), k
