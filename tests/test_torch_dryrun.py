"""The port's multi-rank dry run (``online_gp_torch/parallel/dryrun.py``,
the counterpart of the JAX repo's ``dryrun_multichip``) on 2 spawned gloo
ranks on the CPU: every arm (grid-sharded WISKI, rank-capped Toeplitz
trials, the O-SVGP data-parallel step, the LocalGP experts, the O-SGPR
trials, the q-fantasy lookahead) within 1e-5 of its one-process run; and
the error the bound is held to.
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


def test_the_bound_is_relative_to_max_one_and_the_scale():
    want = {"a": np.array([0.5, -2.0]), "b": np.array([1e-3])}
    assert dryrun._error(want, want) == 0.0
    assert dryrun._error({"a": want["a"] + [0.0, 2e-5], "b": want["b"]}, want) == pytest.approx(1e-5)
    assert dryrun._error({"a": want["a"], "b": want["b"] + 2e-5}, want) == pytest.approx(2e-5)
    assert dryrun._error({"a": want["a"][:1], "b": want["b"]}, want) == float("inf")
