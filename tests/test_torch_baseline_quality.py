"""The JAX package's wrapper-level quality bars for the regression
baselines (tests/regression/test_baseline_models.py), run on the port's
wrappers on the CPU, at the same data, configurations and bars (the
classifiers' are in test_torch_baseline_quality_cls.py). Each runs in
under ~5 s on the CPU, so none is marked ``slow`` (the JAX package marks
them all); ``chip_smoke.py`` phase 8 runs every bar on the card too."""

import numpy as np
import pytest
import torch

from online_gp_torch.api import (
    IdentityStem,
    OnlineExactRegression,
    OnlineLocalGPRegression,
    OnlineSGPRegression,
    OnlineSVGPClassifier,
    OnlineSVGPRegression,
)
from online_gp_torch.data import streaming_friedman

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
def fr():
    return streaming_friedman(n=1200, num_dims=2, seed=0)


def test_exact_regression(fr):
    tx, ty, ex, ey = fr
    m = OnlineExactRegression(IdentityStem(2), tx[:100], ty[:100], lr=0.05, **CPU)
    m.fit(tx[:400], ty[:400], num_epochs=40)
    rmse, nll = m.evaluate(ex, ey)
    assert rmse <= 0.2 and nll <= 1.0
    for i in range(400, 420):
        m.update(tx[i : i + 1], ty[i : i + 1])
    rmse, _ = m.evaluate(ex, ey)
    assert rmse <= 0.2


def test_svgp_regression(fr):
    tx, ty, ex, ey = fr
    m = OnlineSVGPRegression(IdentityStem(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, streaming=True, **CPU)
    m.fit(tx[:800], ty[:800], num_epochs=150, batch_size=256)
    rmse, _ = m.evaluate(ex, ey)
    assert rmse <= 0.6
    for i in range(800, 820):
        m.update(tx[i : i + 1], ty[i : i + 1])
    rmse2, _ = m.evaluate(ex, ey)
    assert np.isfinite(rmse2)


def test_svgp_closed_form_streaming(fr):
    tx, ty, ex, ey = fr
    arms = {}
    for mode in ("closed_form", "grad"):
        m = OnlineSVGPRegression(IdentityStem(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, streaming=True,
                                 variational_mode=mode, **CPU)
        m.fit(tx[:100], ty[:100], num_epochs=60, batch_size=100)
        for i in range(100, 500, 4):
            m.update(tx[i : i + 4], ty[i : i + 4])
        arms[mode], _ = m.evaluate(ex, ey)
    assert np.isfinite(arms["closed_form"])
    assert arms["closed_form"] <= arms["grad"] + 1e-6
    assert arms["closed_form"] <= 0.45
    with pytest.raises(ValueError, match="conjugate"):
        OnlineSVGPClassifier(IdentityStem(2), tx[:20], (ty[:20, 0] > 0).astype(np.int32),
                             variational_mode="closed_form", **CPU)


def test_sgpr_regression(fr):
    tx, ty, ex, ey = fr
    m = OnlineSGPRegression(IdentityStem(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, num_update_steps=0, **CPU)
    m.fit(tx[:800], ty[:800], num_epochs=60)
    rmse, _ = m.evaluate(ex, ey)
    assert rmse <= 0.3
    for i in range(800, 900):
        m.update(tx[i : i + 1], ty[i : i + 1])
    rmse2, _ = m.evaluate(ex, ey)
    assert rmse2 <= rmse + 0.05


def test_localgp_regression(fr):
    tx, ty, ex, ey = fr
    m = OnlineLocalGPRegression(IdentityStem(2), tx[:200], ty[:200], lr=0.05, max_data_per_model=128,
                                max_experts=8, **CPU)
    m.fit(tx[:200], ty[:200], num_epochs=40)
    for i in range(200, 260):
        m.update(tx[i : i + 1], ty[i : i + 1])
    rmse, _ = m.evaluate(ex, ey)
    assert rmse <= 0.35
    assert m.num_experts >= 2
