"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip is skipped and the rest of a run is driven at a
tiny size on the CPU, with the port's wrapper broken one way at a time,
and a number the cell compares reads ten times its limit or more.

  unchanged  a step returns with the state as it was
  half       a step absorbs only the first half of its points
  altered    an answer altered where it is produced: K1's root, its largest
             column 0.1% too large
"""

import time

import pytest

from gpbench import run
from gpbench.tests.small import CELLS, small_cell


def _break(monkeypatch, fault):
    from online_gp_torch.api.regression import OnlineSKIRegression as W

    absorb = W.absorb

    if fault == "unchanged":
        def step(self, x, y):
            state = self.state
            out = absorb(self, x, y)
            self.state = state
            return out
    elif fault == "half":
        def step(self, x, y):
            return absorb(self, x[: len(x) // 2], y[: len(y) // 2])
    else:
        def step(self, x, y):
            out = absorb(self, x, y)
            root = self.state.roots.root[0]
            root[:, int(root.norm(dim=0).argmax())] *= 1.001
            return out
    monkeypatch.setattr(W, "absorb", step)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_run_is_not_correct(monkeypatch, cell, fault):
    _break(monkeypatch, fault)
    out = run.run_cell(small_cell(cell), 2**31 + 99, 1.0, False, "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]
    # the fault, not the tiny size's rounding, fails the run
    assert max(c["value"] / c["limit"] for c in out["checks"].values()) >= 10, out["checks"]
