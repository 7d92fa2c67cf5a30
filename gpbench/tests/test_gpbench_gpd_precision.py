"""The classifier's cell holds a state computed one precision down not
correct: each ``absorb`` call's increment to the classifier's roots and
W D^-1 y rounded through float16 (the nearest format below float32) or
bfloat16, the state kept in float32, planted from outside as
``test_gpbench_faults.py`` plants its faults, with no switch in the
program. Rounding the increments, and not the state, keeps every call's
work in the state: a bfloat16 state stops taking increments once they
fall below its spacing.

On the CPU, at an 8 x 8 grid on the cell built in memory
(``classifier.py``), the rounded state reads ten times a limit set from
that size's sound runs or more. On the card, the ``gpd16-absorb`` cell at
its own size and for BENCHMARK.json's run_seconds comes out not correct
under its limits on three seeds a precision; the numbers it prints are
the upper readings of ``limits/gpd16-absorb.json``:

    python -m pytest -m cuda -s gpbench/tests/test_gpbench_gpd_precision.py
"""

import json
import time

import pytest
import torch

from gpbench import check, run, spec
from gpbench.tests.classifier import classifier_cell

# the program's float32 rounding at this size, about five times over: four
# sound runs on the CPU read roots 1.8e-6-2.9e-6, wty 3.7e-7-9.6e-7,
# state_mean 4.5e-4-6.8e-4, state_var 3.0e-6-5.2e-6; float16 increments
# 1.5e-4-3.1e-4, 8.7e-5-1.7e-4, 0.026-0.069, 6.9e-4-9.0e-4; bfloat16
# increments 1.2e-3-2.3e-3, 6.8e-4-1.2e-3, 0.34-0.60, 5.8e-3-8.0e-3
LIMITS = {"roots": {"limit": 2e-5}, "wty": {"limit": 5e-6}, "state_mean": {"limit": 5e-3},
          "state_var": {"limit": 3e-5}}
SEEDS = [2**31 + 5101, 2**31 + 5102, 2**31 + 5103]
CARD_SEEDS = {"float16": [2**31 + 6201, 2**31 + 6202, 2**31 + 6203],
              "bfloat16": [2**31 + 6211, 2**31 + 6212, 2**31 + 6213]}


def _round_increments(monkeypatch, dtype: torch.dtype):
    from online_gp_torch.api.classification import OnlineSKIClassifier as W

    absorb = W.absorb

    def rounded(self, x, y):
        root, wty = self.state.roots.root.clone(), self.state.wty.clone()
        st = absorb(self, x, y)
        st.roots.root.copy_(root + (st.roots.root - root).to(dtype).to(root.dtype))
        st.wty.copy_(wty + (st.wty - wty).to(dtype).to(wty.dtype))
        return st

    monkeypatch.setattr(W, "absorb", rounded)


def _small(seed):
    return run.run_cell(classifier_cell(LIMITS, grid=8, pool=20000), seed, 1.0, False, "cpu", time.perf_counter())


def test_the_sound_classifier_is_correct_at_this_size():
    out = _small(SEEDS[0])
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_a_state_one_precision_down_is_not_correct(monkeypatch, dtype):
    _round_increments(monkeypatch, getattr(torch, dtype))
    out = _small(SEEDS[0])
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert not out["correct"], out["checks"]
    assert max(c["value"] / c["limit"] for c in out["checks"].values()) >= 10, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,seed", [(d, s) for d, seeds in CARD_SEEDS.items() for s in seeds])
def test_a_state_one_precision_down_is_not_correct_on_the_card(monkeypatch, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("the cell runs at its own size on a CUDA card")
    _round_increments(monkeypatch, getattr(torch, dtype))
    cell = spec.load_cell("gpd16-absorb")
    seconds = spec.load_json(spec.ROOT / "BENCHMARK.json")["run_seconds"]
    out = run.run_cell(cell, seed, seconds, False, "cuda", time.perf_counter())
    print(json.dumps({"cell": cell.name, "seed": seed, dtype: out["numbers"]}), flush=True)
    ok, shown = check.verdict(out["numbers"], cell.limits)
    assert not ok and not out["correct"], shown
