"""The JAX package's wrapper-level quality bars for the classification
baselines (tests/regression/test_baseline_models.py::test_exact_classifier
and ::test_svgp_classifier), run on the port's wrappers on the CPU, at the
same data, configurations and bars. ``test_svgp_classifier`` runs in
under ~5 s on the CPU and is unmarked; ``test_exact_classifier`` takes
~13 s on one CPU thread (the kernel matrix's backward over the 512-row
buffer, at two classes, 140 times) and is marked ``slow``, as the JAX
package marks both; ``chip_smoke.py`` phase 8 runs both on the card."""

import pytest
import torch

from online_gp_torch.api import IdentityStem, OnlineExactClassifier, OnlineSVGPClassifier
from online_gp_torch.data import banana_dataset

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def banana():
    return banana_dataset(n=800, seed=0)


@pytest.mark.slow
def test_exact_classifier(banana):
    bx, by, ex, ey = banana
    c = OnlineExactClassifier(IdentityStem(2), bx[:100], by[:100], lr=0.05, **CPU)
    c.fit(bx[:400], by[:400], num_epochs=40)
    assert c.evaluate(ex, ey) >= 0.89
    correct = 0
    for i in range(400, 500):
        pred = c.predict(bx[i : i + 1])
        correct += int(pred[0] == by[i])
        c.update(bx[i : i + 1], by[i : i + 1])
    assert correct / 100 >= 0.80
    assert c.evaluate(ex, ey) >= 0.89


def test_svgp_classifier(banana):
    bx, by, ex, ey = banana
    v = OnlineSVGPClassifier(IdentityStem(2), bx[:100], by[:100], num_inducing=32, lr=0.1, **CPU)
    v.fit(bx[:600], by[:600], num_epochs=150, batch_size=256)
    assert v.evaluate(ex, ey) >= 0.85
    correct = 0
    for i in range(600, 640):
        pred, _ = v.predict(bx[i : i + 1])
        correct += int(pred[0] == by[i])
        v.update(bx[i : i + 1], by[i : i + 1])
    assert correct / 40 >= 0.65
    assert v.evaluate(ex, ey) >= 0.75
