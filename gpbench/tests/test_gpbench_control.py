"""On the card: the control, the reference in the program's place in the
precision below the configuration's (float32 with TF32 matmuls, the root
kept by blocked streaming updates), comes out not correct under each
cell's limits, while the program's run, in the same process and on the
same requests, comes out correct. Each cell runs at its own size for
BENCHMARK.json's run_seconds.

    python -m pytest -m cuda gpbench/tests/test_gpbench_control.py
"""

import time

import pytest
import torch

from gpbench import check, spec
from gpbench import run
from gpbench.tests.small import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    c = spec.load_cell(cell)
    seconds = spec.load_json(spec.ROOT / "BENCHMARK.json")["run_seconds"]
    out = run.run_cell(c, 2**31 + 4242, seconds, False, "cuda", time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    ok, shown = check.verdict(out["control"], c.limits)
    assert not ok, shown
