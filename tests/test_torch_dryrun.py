"""The port's multi-rank dry run (``online_gp_torch/parallel/dryrun.py``,
the counterpart of the JAX repo's ``dryrun_multichip``) on 2 spawned gloo
ranks on the CPU: every arm (grid-sharded WISKI, dense and past
``max_cholesky_size``, rank-capped Toeplitz trials, the O-SVGP
data-parallel step, the LocalGP experts, the O-SGPR trials, the q-fantasy
lookahead) within 1e-5 of its one-process run; the iterative arm's
one-process run takes the CG/SLQ MLL and LOVE; and the error the bound is
held to.
"""

import numpy as np
import pytest
import torch

from online_gp_torch.parallel import dryrun


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_every_arm_matches_its_one_process_run(tmp_path, capsys):
    errors = dryrun.dryrun_multichip(2, "cpu", store=str(tmp_path / "store"))
    assert set(errors) == set(dryrun.ARMS)
    assert all(0.0 <= e <= dryrun.BOUND for e in errors.values()), errors
    assert "dryrun_multichip(2) OK" in capsys.readouterr().out


def test_the_iterative_arm_runs_cg_slq_and_love(monkeypatch):
    """The one-process run of ``grid_sharded_iterative`` goes through the
    CG/SLQ MLL and the LOVE Lanczos (m = 64 > max_cholesky_size 32, rank
    16 < 64), and gives finite values of the arm's shapes."""
    from online_gp_torch.models import wiski as tw

    calls = []
    iterative, lanczos = tw._mll_inner_iterative, tw.lanczos
    monkeypatch.setattr(tw, "_mll_inner_iterative", lambda *a: calls.append("mll") or iterative(*a))
    monkeypatch.setattr(tw, "lanczos", lambda *a: calls.append("love") or lanczos(*a))
    assert "grid_sharded_iterative" in dryrun.ARMS
    out = dryrun._grid_sharded_iterative(dryrun._World(0, 1, torch.device("cpu"), 2))
    assert calls == ["mll", "love"]
    assert {k: v.shape for k, v in out.items()} == {"loss": (1,), "params": (4,), "mean": (16,), "var": (16,)}
    assert all(np.isfinite(v).all() for v in out.values())


def test_the_bound_is_relative_to_max_one_and_the_scale():
    want = {"a": np.array([0.5, -2.0]), "b": np.array([1e-3])}
    assert dryrun._error(want, want) == 0.0
    assert dryrun._error({"a": want["a"] + [0.0, 2e-5], "b": want["b"]}, want) == pytest.approx(1e-5)
    assert dryrun._error({"a": want["a"], "b": want["b"] + 2e-5}, want) == pytest.approx(2e-5)
    assert dryrun._error({"a": want["a"][:1], "b": want["b"]}, want) == float("inf")
