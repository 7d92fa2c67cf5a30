"""How the Dirichlet classifier takes its inputs in: through the staging and
replay helper it shares with the regression wrapper
(``api.regression.StagedInputs``).

The CPU tests drive ``OnlineSKIClassifier`` at an 8 x 8 grid: numpy, tensor
and list inputs leave one state; the replay buffer keeps the caller's own
array; each entry point is one span. The ``cuda``-marked test holds the
classifier at the published grid (16, two classes) to one wait on the card
a call over back-to-back 4,096-point absorbs, with no staging slot waited
for, and its roots bit for bit those of the same calls copied from
pageable memory (``python -m pytest --noconftest -m cuda
tests/test_torch_classifier_inputs.py``; no JAX import here).
"""

import numpy as np
import pytest
import torch

from online_gp_torch.api import IdentityStem, OnlineSKIClassifier, OnlineSKIRegression
from online_gp_torch.api.regression import StagedInputs, stage_host
from online_gp_torch.logging import timing

DEVICE_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed, n):
    """n points uniform on [-1, 1]^2 and their int64 labels: the noisy
    target sin(3 x1) cos(2 x2) + 0.1 N(0, 1) cut at 0."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    f = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, (f > 0).astype(np.int64)[:, None]


def _classifier(device="cpu", grid_size=8):
    x, y = _data(0, 64)
    return OnlineSKIClassifier(IdentityStem(2), x, y, grid_size=grid_size, num_classes=2, device=device)


def _state(clf):
    st = clf.state
    return [st.wty, st.ydy, st.d_logdet, st.roots.mat, st.roots.root, st.roots.inv_root]


def _as(a, kind):
    return {"numpy": a, "tensor": torch.as_tensor(a), "list": a.tolist()}[kind]


def test_the_classifier_shares_the_regressions_staging():
    assert issubclass(OnlineSKIClassifier, StagedInputs) and issubclass(OnlineSKIRegression, StagedInputs)
    for name in ("_on_device", "_inputs", "_replay"):
        assert name not in vars(OnlineSKIClassifier) and name not in vars(OnlineSKIRegression), name


@pytest.mark.parametrize("kind", ["tensor", "list"])
def test_absorb_of_numpy_tensor_and_list_inputs_leaves_one_state(kind):
    arrays, other = _classifier(), _classifier()
    x, y = _data(1, 40)
    arrays.absorb(x, y)
    other.absorb(_as(x, kind), _as(y, kind))
    for a, b in zip(_state(arrays), _state(other)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert arrays.state.num_data == other.state.num_data
    assert arrays.buffer.all().tobytes() == other.buffer.all().tobytes()


@pytest.mark.parametrize("call", ["absorb", "update"])
def test_replay_buffer_keeps_the_callers_array(call):
    """The replay buffer takes the caller's host array itself, bit for bit
    and in its dtype, with no copy back from the device; writing over the
    array after the call changes neither the buffer nor the state."""
    clf = _classifier()
    x, y = _data(2, 40)
    spans = _spans(lambda: getattr(clf, call)(x, y))
    assert "ogp.sync.host_copy" not in spans
    kept = clf.buffer.all()[-40:]
    assert kept.dtype == x.dtype and kept.tobytes() == x.tobytes()
    state = [t.clone() for t in _state(clf)]
    x[:], y[:] = 7.0, 1
    assert clf.buffer.all()[-40:].tobytes() == kept.tobytes()
    for a, b in zip(state, _state(clf)):
        assert torch.equal(a, b)


def _spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ours = sorted((e for e in prof.events() if e.name.startswith(timing.PREFIX)), key=lambda e: e.time_range.start)
    return [e.name for e in ours]


@pytest.mark.parametrize("host_arrays", [True, False])
def test_absorb_spans_nest_by_layer(host_arrays):
    clf = _classifier()
    x, y = _data(3, 40)
    if not host_arrays:
        x, y = torch.as_tensor(x), torch.as_tensor(y)
    want = ["ogp.absorb", "ogp.wiski_stream", "ogp.roots_stream", "ogp.sync.stencil_check"]
    assert _spans(lambda: clf.absorb(x, y)) == want + ([] if host_arrays else ["ogp.sync.host_copy"])


def test_update_and_predict_are_spans():
    clf = _classifier()
    x, y = _data(4, 4)
    spans = _spans(lambda: (clf.update(x[:1], y[:1]), clf.predict(x)))
    assert spans[0] == "ogp.update" and spans.count("ogp.sync.losses") == 1
    assert spans.count("ogp.predict") == 1 and spans.index("ogp.predict") > spans.index("ogp.sync.losses")


@pytest.mark.cuda
def test_back_to_back_absorbs_wait_once_a_call():
    """On the card, grid 16 and two classes: eight 4,096-point absorbs of
    host arrays back to back stage every input with no slot waited for,
    wait on the card once a call (the stencil check) and nowhere outside a
    sync span; L equals, bit for bit, that of the same calls on tensors
    copied from pageable memory, and W D^-1 y lies within 1e-6 of it
    (its scatter-add sums on atomics, in an order that varies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the port's kernels have no CPU mode")
    staged, pageable = _classifier("cuda", 16), _classifier("cuda", 16)
    calls = [_data(10 + i, 4096) for i in range(8)]
    staged.absorb(*_data(9, 4096))  # warm
    pageable.absorb(*(torch.as_tensor(a, device="cuda") for a in _data(9, 4096)))
    torch.cuda.synchronize()
    copies, waits = stage_host.staged_copies, stage_host.stage_waits
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for x, y in calls:
            staged.absorb(x, y)
        torch.cuda.synchronize()
    assert stage_host.staged_copies - copies == 16
    assert stage_host.stage_waits == waits
    events = prof.events()
    tops = [e for e in events if e.name == "ogp.absorb"]
    syncs = [e for e in events if e.name.startswith("ogp.sync.")]
    assert len(tops) == 8 and [e.name for e in syncs] == ["ogp.sync.stencil_check"] * 8
    inside = lambda w, s: s.time_range.start <= w.time_range.start and w.time_range.end <= s.time_range.end  # noqa: E731
    device_waits = [e for e in events if e.name in DEVICE_WAITS and any(inside(e, t) for t in tops)]
    assert all(any(inside(w, s) for s in syncs) for w in device_waits)
    for x, y in calls:
        pageable.absorb(torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(staged.state.roots.root, pageable.state.roots.root)
    assert torch.equal(staged.state.roots.inv_root, pageable.state.roots.inv_root)
    wty, want = staged.state.wty, pageable.state.wty
    assert float((wty - want).abs().max() / want.abs().max()) <= 1e-6
    assert staged.buffer.all().tobytes() == pageable.buffer.all().tobytes()
