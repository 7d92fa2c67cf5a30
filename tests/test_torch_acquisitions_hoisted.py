"""The acquisitions of the port below full rank and in their batched,
hoisted forms (the companion of test_torch_acquisitions.py, whose fixture
and builders it shares): the MC forms with max_root_decomposition_size 32
at m = 100 (a Lanczos root started from JAX's start vector) against the
JAX package at float64; the batched form (R, q, d) -> (R,) against the
rows one by one; and the hoisted caches and root (``acquisition_context``,
qMVES's y*) against the per-call form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_torch.bayesopt import acquisitions as tacq
from online_gp_torch.config import SolverConfig
from online_gp_torch.models import wiski as tw
from test_torch_acquisitions import KEY, LOW_RANK, S, _build, _check, _normals, _points, post  # noqa: F401

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over small ops cost more than they
    give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture
def low_rank(monkeypatch):
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (100,), jnp.float64))
    monkeypatch.setattr(tw, "root_start_vector", lambda m, dtype=torch.float32, device=None:
                        torch.tensor(v0, dtype=dtype, device=device))
    return True


@pytest.mark.parametrize("name, q, variant", [("ei", 2, None), ("nei", 2, None), ("kg", 1, 5),
                                              ("mves", 2, "joint"), ("ucb", 3, None)])
def test_below_full_rank_matches(post, low_rank, name, q, variant):
    jf, tf = _build(name, q, post, LOW_RANK, variant)
    _check(jf, tf, _points(q, 7))


@pytest.mark.parametrize("name, q, variant", [("ei", 1, None), ("ucb", 2, None), ("kg", 1, 5), ("kg", 2, 0),
                                              ("mves", 2, "joint"), ("mves", 1, "gumbel"), ("nipv", 1, None),
                                              ("nei", 2, None)])
def test_batched_rows_and_hoisted_context(post, name, q, variant):
    _, _, _, tm, tp, ts, ex = post
    _, tf = _build(name, q, post, 100, variant)
    X = torch.tensor(np.stack([_points(q, s) for s in range(3)]))
    rows = torch.stack([tf(X[r]) for r in range(3)])
    batched = tf(X)
    assert batched.shape == (3,)
    torch.testing.assert_close(batched, rows, rtol=1e-12, atol=1e-14)
    if name == "nipv":
        return
    ctx = tacq.acquisition_context(tm, tp, ts, SolverConfig())
    kw = dict(context=ctx)
    if name == "mves":
        ystar = tacq.mves_max_values(tm, tp, ts, torch.tensor(ex["cand"]), _build_max_samples(variant), SolverConfig(),
                                     variant, ctx)
        kw["y_star"] = ystar
    torch.testing.assert_close(tf(X, **kw), rows, rtol=1e-12, atol=1e-14)


def _build_max_samples(variant):
    k_max, _ = jax.random.split(KEY)
    if variant == "joint":
        return torch.tensor(_normals(k_max, S, 100))
    return torch.tensor(np.asarray(jax.random.uniform(k_max, (S,), jnp.float64, minval=1e-4, maxval=1 - 1e-4)))


