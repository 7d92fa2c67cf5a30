"""The port's spans (``online_gp_torch.logging.timing``): under
``torch.profiler`` each layer boundary of the streaming wrapper's paths is
one ``ogp.*`` host range inside the one that encloses it, each wait on the
card one ``ogp.sync.*`` range; with no profiler recording a span is one
shared no-op and the results are the same.

The CPU tests drive the wrapper at an 8 x 8 grid, and hold what its replay
buffer keeps of a caller's host arrays. The ``cuda``-marked tests hold the
sync spans complete on the card, where every wait on the device is a
``cudaStreamSynchronize`` or ``cudaEventSynchronize`` in the trace, and
the staged host arrays bit for bit to device tensors (``python -m pytest
--noconftest -m cuda tests/test_torch_spans.py``; no JAX import here).
"""

import numpy as np
import pytest
import torch

from online_gp_torch.api import IdentityStem, OnlineSKIRegression
from online_gp_torch.api.regression import stage_host
from online_gp_torch.logging import span, spanned, timing

FUNCTION_SCOPE = 0  # at::RecordScope::FUNCTION, the ATen operators' own
DEVICE_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    return x, (np.sin(3 * x[:, :1]) * np.cos(2 * x[:, 1:]) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)


def _wrapper(device="cpu", grid_size=8):
    x, y = _data(0, 64)
    return OnlineSKIRegression(IdentityStem(2), x, y, grid_size=grid_size, device=device)


def _profiled(fn):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    return prof.events()


def _spans(events):
    """The program's spans in start order: (name, names of the enclosing program spans, outermost first)."""
    out = []
    for e in sorted((e for e in events if e.name.startswith(timing.PREFIX)), key=lambda e: e.time_range.start):
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(timing.PREFIX):
                chain.append(p.name)
            p = p.cpu_parent
        out.append((e.name, tuple(reversed(chain))))
    return out


@pytest.mark.parametrize("host_arrays", [False, True])
def test_absorb_spans_nest_by_layer(host_arrays):
    reg = _wrapper()
    x, y = _data(1, 40)
    if not host_arrays:
        x, y = torch.as_tensor(x), torch.as_tensor(y)
    spans = _spans(_profiled(lambda: reg.absorb(x, y)))
    core = ("ogp.absorb", "ogp.wiski_stream")
    want = [("ogp.absorb", ()), ("ogp.wiski_stream", ("ogp.absorb",)), ("ogp.roots_stream", core),
            ("ogp.sync.stencil_check", core + ("ogp.roots_stream",))]
    if not host_arrays:  # the replay buffer keeps a host array as given, a tensor copied back
        want.append(("ogp.sync.host_copy", ("ogp.absorb",)))
    assert spans == want
    assert sum(name.startswith("ogp.sync.") for name, _ in spans) == (1 if host_arrays else 2)


def _as(x, kind):
    """``x`` as the caller hands it over: float32, float64, or a strided
    float32 view into a larger array."""
    if kind == "view":
        big = np.zeros((2 * x.shape[0], x.shape[1] + 1), np.float32)
        big[::2, 1:] = x
        return big[::2, 1:]
    return x.astype(kind)


@pytest.mark.parametrize("call", ["absorb", "prequential"])
@pytest.mark.parametrize("kind", ["float32", "float64", "view"])
def test_replay_buffer_keeps_the_callers_arrays(call, kind):
    """The replay buffer takes the caller's host array itself, bit for bit
    and in its dtype; writing over the array after the call changes neither
    the buffer nor the state."""
    x0, y0 = _data(0, 64)
    reg = OnlineSKIRegression(IdentityStem(2), _as(x0, kind), _as(y0, kind), grid_size=8, device="cpu")
    x, y = _data(8, 40)
    x, y = _as(x, kind), _as(y, kind)
    assert x.flags.c_contiguous == (kind != "view")
    getattr(reg, call)(x, y)
    kept = reg.buffer.all()[-40:]
    assert kept.dtype == x.dtype and kept.tobytes() == np.ascontiguousarray(x).tobytes()
    state = [t.clone() for t in (reg.state.wty, reg.state.roots.root, reg.state.roots.inv_root)]
    x[:], y[:] = 7.0, -7.0
    assert reg.buffer.all()[-40:].tobytes() == kept.tobytes()
    for a, b in zip(state, (reg.state.wty, reg.state.roots.root, reg.state.roots.inv_root)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_absorb_of_host_arrays_equals_absorb_of_tensors(kind):
    x0, y0 = _data(0, 64)
    arrays, tensors = (OnlineSKIRegression(IdentityStem(2), _as(x0, kind), _as(y0, kind), grid_size=8, device="cpu")
                       for _ in range(2))
    x, y = _data(9, 40)
    x, y = _as(x, kind), _as(y, kind)
    arrays.absorb(x, y)
    tensors.absorb(torch.as_tensor(x), torch.as_tensor(y))
    for a, b in [(arrays.state.wty, tensors.state.wty), (arrays.state.roots.root, tensors.state.roots.root),
                 (arrays.state.roots.inv_root, tensors.state.roots.inv_root)]:
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert arrays.state.num_data == tensors.state.num_data
    assert arrays.buffer.all().tobytes() == tensors.buffer.all().tobytes()


def test_cache_rebuilds_against_conditionings():
    reg = _wrapper()
    x, y = _data(2, 3)
    xq, _ = _data(3, 5)

    def calls():
        reg.update(x[:1], y[:1])  # the hypers move: the caches are dropped
        reg.predict(xq)  # a rebuild
        reg.update(x[1:2], y[1:2], update_gp=False, update_stem=False)  # a conditioning
        reg.predict(xq)  # the conditioned caches, no rebuild

    spans = _spans(_profiled(calls))
    names = [name for name, _ in spans]
    assert names.count("ogp.wiski_prediction_caches") == 1
    assert names.count("ogp.wiski_pred_cache_condition") == 1
    assert ("ogp.wiski_prediction_caches", ("ogp.predict",)) in spans
    assert ("ogp.wiski_pred_cache_condition", ("ogp.update",)) in spans
    assert names.count("ogp.hyper") == 2 and names.count("ogp.sync.losses") == 2


def test_prequential_spans_hold_both_streams():
    reg = _wrapper()
    x, y = _data(4, 40)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    spans = _spans(_profiled(lambda: reg.prequential(x, y)))
    outer = ("ogp.prequential", "ogp.wiski_prequential_stream")
    assert spans == [
        ("ogp.prequential", ()),
        ("ogp.wiski_prediction_caches", ("ogp.prequential",)),
        ("ogp.wiski_prequential_stream", ("ogp.prequential",)),
        ("ogp.sync.stencil_check", outer),  # the caches' stream, K3's
        ("ogp.wiski_stream", outer),
        ("ogp.roots_stream", outer + ("ogp.wiski_stream",)),
        ("ogp.sync.stencil_check", outer + ("ogp.wiski_stream", "ogp.roots_stream")),
        ("ogp.sync.host_copy", ("ogp.prequential",)),
    ]


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler recording nothing is recorded, and absorb leaves
    the state a traced absorb leaves, bit for bit."""
    traced, plain = _wrapper(), _wrapper()
    x, y = _data(5, 40)
    _profiled(lambda: traced.absorb(x, y))

    def refuse(*args, **kwargs):
        raise AssertionError("a span was recorded with no profiler recording")

    monkeypatch.setattr(timing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("absorb") is span("other")
    plain.absorb(x, y)
    for a, b in [(traced.state.wty, plain.state.wty), (traced.state.roots.root, plain.state.roots.root),
                 (traced.state.roots.inv_root, plain.state.roots.inv_root), (traced.state.roots.mat, plain.state.roots.mat)]:
        assert torch.equal(a, b)
    assert traced.state.num_data == plain.state.num_data


def test_spans_are_function_scope_ranges():
    """A span is a host range of the operators' scope, not a user
    annotation, which the profiler would also copy onto the device's row;
    the decorator makes each call one span and passes the result through."""

    @spanned("twice")
    def twice(t):
        with span("inner"):
            return 2 * t

    events = _profiled(lambda: [twice(torch.ones(2)) for _ in range(3)])
    ours = [e for e in events if e.name.startswith(timing.PREFIX)]
    assert sorted(e.name for e in ours) == ["ogp.inner"] * 3 + ["ogp.twice"] * 3
    assert all(e.scope == FUNCTION_SCOPE for e in ours)
    assert all(e.cpu_parent.name == "ogp.twice" for e in ours if e.name == "ogp.inner")
    assert torch.equal(twice(torch.ones(2)), torch.full((2,), 2.0))
    assert twice.__name__ == "twice"


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["absorb", "update", "predict", "prequential", "hyper_step"])
def test_every_wait_on_the_card_is_a_sync_span(call):
    """On the card, at the default grid (m = 900) with host arrays in: each
    wait on the device inside the call lies inside an ``ogp.sync.*`` span,
    each such span holds one, and no span is on the device's row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the port's kernels have no CPU mode")
    reg = _wrapper("cuda", grid_size=30)
    x, y = _data(6, 4096)
    reg.predict(x[:8])
    args = {"absorb": (x, y), "update": (x[:1], y[:1]), "predict": (x[:256],), "prequential": (x[:1024], y[:1024]),
            "hyper_step": (x[:1], y[:1])}[call]
    getattr(reg, call)(*args)  # warm
    torch.cuda.synchronize()
    events = _profiled(lambda: getattr(reg, call)(*args))
    assert not [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith(timing.PREFIX)]
    inside = lambda w, s: s.time_range.start <= w.time_range.start and w.time_range.end <= s.time_range.end  # noqa: E731
    (top,) = [e for e in events if e.name == timing.PREFIX + call]
    syncs = [e for e in events if e.name.startswith("ogp.sync.")]
    waits = [e for e in events if e.name in DEVICE_WAITS and inside(e, top)]  # not the profiler's own
    loose = [w.name + " under " + (w.cpu_parent.name if w.cpu_parent else "nothing")
             for w in waits if not any(inside(w, s) for s in syncs)]
    assert not loose, loose
    assert all(any(inside(w, s) for w in waits) for s in syncs), [s.name for s in syncs]


@pytest.mark.cuda
def test_staged_absorbs_match_device_tensors():
    """On the card: twenty absorbs of host arrays back to back, the caller
    writing each block into one numpy buffer while the last call's chunks
    may still run, leave L and W y bit for bit those of the same calls on
    device tensors; every input is staged (one call outgrows the slots) and
    no slot is waited for. W y's scatter-add sums on atomics, in an order
    that differs from run to run, unless deterministic algorithms are on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the port's kernels have no CPU mode")
    deterministic, warn_only = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _staged_against_direct()
    finally:
        torch.use_deterministic_algorithms(deterministic, warn_only=warn_only)


def _staged_against_direct():
    staged, direct = _wrapper("cuda", grid_size=30), _wrapper("cuda", grid_size=30)
    sizes = [256] * 10 + [1024] + [256] * 9
    xs, ys = _data(10, sum(sizes))
    bx, by = np.empty((max(sizes), 2), np.float32), np.empty((max(sizes), 1), np.float32)
    torch.cuda.synchronize()
    copies, waits = stage_host.staged_copies, stage_host.stage_waits
    at = 0
    for n in sizes:
        bx[:n], by[:n] = xs[at:at + n], ys[at:at + n]
        staged.absorb(bx[:n], by[:n])
        at += n
    assert stage_host.staged_copies - copies == 40
    assert stage_host.stage_waits == waits
    at = 0
    for n in sizes:
        direct.absorb(torch.as_tensor(xs[at:at + n], device="cuda"), torch.as_tensor(ys[at:at + n], device="cuda"))
        at += n
    torch.cuda.synchronize()
    assert torch.equal(staged.state.roots.root, direct.state.roots.root)
    assert torch.equal(staged.state.wty, direct.state.wty)
    assert staged.buffer.all().tobytes() == direct.buffer.all().tobytes()
