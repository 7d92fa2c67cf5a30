"""The port's spans (``online_gp_torch.logging.timing``): under
``torch.profiler`` each layer boundary of the streaming wrapper's paths is
one ``ogp.*`` host range inside the one that encloses it, each wait on the
card one ``ogp.sync.*`` range; with no profiler recording a span is one
shared no-op and the results are the same.

The CPU tests drive the wrapper at an 8 x 8 grid. The ``cuda``-marked test
holds the sync spans complete on the card, where every wait on the device
is a ``cudaStreamSynchronize`` in the trace (``python -m pytest
--noconftest -m cuda tests/test_torch_spans.py``; no JAX import here).
"""

import numpy as np
import pytest
import torch

from online_gp_torch.api import IdentityStem, OnlineSKIRegression
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
            ("ogp.sync.stencil_check", core + ("ogp.roots_stream",)), ("ogp.sync.host_copy", ("ogp.absorb",))]
    if host_arrays:  # the inputs' copies to the wrapper's device come first
        want[1:1] = [("ogp.sync.input_copy", ("ogp.absorb",))] * 2
    assert spans == want
    assert sum(name.startswith("ogp.sync.") for name, _ in spans) == (4 if host_arrays else 2)


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
