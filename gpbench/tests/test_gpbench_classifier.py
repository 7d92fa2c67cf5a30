"""The classifier's factory (``wrappers/online_ski_classifier.py``) through
a whole run on the CPU, on a cell built in memory (``classifier.py``: no
file of the benchmark names it) at an 8 x 8 grid: the check replays the
labels' Dirichlet targets and noises for each class, and a run whose
classifier is broken underneath reads ten times the sound run's largest
number or more.

  swapped    each point's two noises swapped between the classes
  unit       unit noise: the labels taken as one-hot regression targets
  copied     class 1's state replaced by class 0's after each absorb
  dropped    one window request's points left out
"""

import time

import pytest
import torch

from gpbench import run
from gpbench.tests.classifier import classifier_cell

SEED = 2**31 + 99
# the program's float32 rounding at this size (float64 inputs read roots
# 2.4e-7, state_mean 2.0e-4, state_var 1.6e-6: the grid's and the
# transform's float32 alone)
LIMITS = {"roots": {"limit": 5e-5}, "wty": {"limit": 5e-6}, "state_mean": {"limit": 2e-2},
          "state_var": {"limit": 1e-4}}


def _run(seed=SEED):
    return run.run_cell(classifier_cell(LIMITS, grid=8, pool=20000), seed, 1.0, False, "cpu", time.perf_counter())


@pytest.fixture(scope="module")
def sound():
    return _run()


@pytest.mark.parametrize("seed", [SEED, 2**31 + 4243])
def test_the_classifier_is_correct_at_rounding_level(seed, sound):
    out = sound if seed == SEED else _run(seed)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"], out["checks"]
    assert set(out["numbers"]) == set(LIMITS)


def _break(monkeypatch, fault):
    from online_gp_torch.api.classification import OnlineSKIClassifier as W

    absorb, transform = W.absorb, W._transform
    if fault == "swapped":
        def swapped(self, labels):
            targets, sigma2 = transform(self, labels)
            return targets, sigma2.flip(1)
        monkeypatch.setattr(W, "_transform", swapped)
    elif fault == "unit":
        def unit(self, labels):
            onehot = torch.nn.functional.one_hot(torch.as_tensor(labels).reshape(-1), self.num_classes).float()
            return onehot, torch.ones_like(onehot)
        monkeypatch.setattr(W, "_transform", unit)
    elif fault == "copied":
        def copied(self, x, y):
            out = absorb(self, x, y)
            st = self.state
            for t in (st.roots.mat, st.roots.root, st.roots.inv_root, st.wty):
                if t is not None:
                    t[1] = t[0]
            return out
        monkeypatch.setattr(W, "absorb", copied)
    else:
        calls = []

        def dropped(self, x, y):
            calls.append(len(x))
            return self.state if len(calls) == 3 else absorb(self, x, y)  # the window's first request
        monkeypatch.setattr(W, "absorb", dropped)


@pytest.mark.parametrize("fault", ["swapped", "unit", "copied", "dropped"])
def test_a_broken_classifier_is_not_correct(monkeypatch, sound, fault):
    _break(monkeypatch, fault)
    out = _run()
    assert not out["correct"], out["checks"]
    assert max(out["numbers"].values()) >= 10 * max(sound["numbers"].values()), (out["numbers"], sound["numbers"])
