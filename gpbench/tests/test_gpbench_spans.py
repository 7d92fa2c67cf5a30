"""The program's spans in a traced window (``gpbench/spans.py``), on a
synthetic profile on the CPU: six requests of an absorb, each with the
port's spans, its host waits, three kernels and a copy on the device, and
the harness's marker before each request and after the last. The counted
part is requests 2 to 5 (``trace.HEAD``), 4,000 us on the profiler's clock.
"""

from typing import List, NamedTuple

import pytest
from torch.autograd import DeviceType

from gpbench import spans, trace

REQUESTS = 6
PERIOD = 1000.0


class Range(NamedTuple):
    start: float
    end: float


class Event:
    """What ``trace.reduce`` reads of a ``torch.profiler`` event."""

    def __init__(self, name, start, end, device=DeviceType.CPU):
        self.name, self.time_range, self.device_type = name, Range(start, end), device
        self.cpu_children: List["Event"] = []

    def holds(self, *children):
        self.cpu_children.extend(children)
        return self


class Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _device(R):
    return [Event(trace.MARKER, R + 1, R + 2, DeviceType.CUDA),
            Event("k_core", R + 20, R + 25, DeviceType.CUDA),
            Event("k_loop_a", R + 40, R + 60, DeviceType.CUDA),
            Event("k_loop_b", R + 62, R + 77, DeviceType.CUDA),
            Event("Memcpy DtoH (Device -> Pageable)", R + 88, R + 90, DeviceType.CUDA)]


def _request(r, with_spans=True, stray_wait=False):
    """The host's events of request r: (events, the request span)."""
    R = r * PERIOD
    wait = lambda s, e: Event("cudaStreamSynchronize", R + s, R + e)  # noqa: E731
    launch = lambda s: Event("cudaLaunchKernel", R + s, R + s + 1)  # noqa: E731
    leaves = {"input": wait(6.5, 7.5), "launch_core": launch(11), "check": wait(31.5, 32.5), "launch_loop": launch(35),
              "copy": wait(86.5, 91)}
    if stray_wait:  # a wait on the device outside every sync span
        leaves["stray"] = wait(50, 51)
    request = Event(spans.REQUEST, R + 3, R + 100)
    if not with_spans:
        request.holds(*leaves.values())
        return list(leaves.values()) + [request], request
    loop = Event("ogp.roots_stream", R + 30, R + 78).holds(
        Event("ogp.sync.stencil_check", R + 31, R + 33).holds(leaves["check"]), leaves["launch_loop"],
        *([leaves["stray"]] if stray_wait else []))
    core = Event("ogp.wiski_stream", R + 10, R + 80).holds(leaves["launch_core"], loop)
    absorb = Event("ogp.absorb", R + 5, R + 95).holds(
        Event("ogp.sync.input_copy", R + 6, R + 8).holds(leaves["input"]), core,
        Event("ogp.sync.host_copy", R + 85, R + 93).holds(leaves["copy"]))
    request.holds(absorb)
    ours = [absorb, *absorb.cpu_children, *core.cpu_children, *loop.cpu_children]
    return [e for e in ours if e.name.startswith("ogp.")] + list(leaves.values()) + [request], request


def _profile(with_spans=True, on_device_row=False):
    events = []
    for r in range(REQUESTS):
        events += _device(r * PERIOD) + _request(r, with_spans, stray_wait=r == 3)[0]
        if on_device_row:  # a user-scope range's copy on the device's row, over the kernels inside it
            events.append(Event("ogp.absorb", r * PERIOD + 20, r * PERIOD + 90, DeviceType.CUDA))
    events.append(Event(trace.MARKER, REQUESTS * PERIOD + 1, REQUESTS * PERIOD + 2, DeviceType.CUDA))
    return Profile(events)


def _reduced(**kw):
    prof = _profile(**kw)
    return prof, trace.reduce(prof, 10, 1.0)


def test_the_counted_part():
    _, tr = _reduced()
    assert (tr.lo, tr.hi, tr.first, tr.last) == (2001.0, 6001.0, 12, 16)
    assert len(tr.kernels) == 12 and len(tr.copies) == 4


def test_the_accepted_reduction_reads_the_same_with_host_spans():
    """The port's spans are host ranges: the harness's reduction, and every
    metric read from it, is what it was without them."""
    assert _reduced()[1] == _reduced(with_spans=False)[1]


def test_a_span_on_the_device_row_would_count_as_a_kernel():
    """Why the port's spans are function-scope ranges: a user-scope range's
    copy on the device's row is one more kernel to the reduction, and its
    union covers the idle gaps inside it."""
    _, tr = _reduced()
    _, annotated = _reduced(on_device_row=True)
    assert len(annotated.kernels) == len(tr.kernels) + 4
    assert trace.union_us(annotated.kernels) > trace.union_us(tr.kernels)


def test_each_idle_instant_goes_to_the_innermost_span():
    prof, tr = _reduced()
    out = spans.split(prof.events(), tr)
    # a request's window [R+1, R+1001) idles 958 us: 18 in the wrapper ([5, 10), [80, 95) less the copy), 17 in the
    # core ([10, 20), [25, 30), [78, 80)), 13 in the loop ([30, 40), [60, 62), [77, 78)), 910 with no span open
    assert out["idle_wrapper.absorb"] == pytest.approx(100 * 4 * 18 / 4000)
    assert out["idle_core.absorb"] == pytest.approx(100 * 4 * 17 / 4000)
    assert out["idle_stream_loop.absorb"] == pytest.approx(100 * 4 * 13 / 4000)
    assert out["idle_no_span"] == pytest.approx(100 * 4 * 910 / 4000)
    device_idle = 100 * (1 - trace.union_us(tr.kernels + tr.copies) / (tr.hi - tr.lo))
    layers = sum(out[name] for name, _, _ in spans.LAYERS)
    assert layers <= device_idle and layers + out["idle_no_span"] == pytest.approx(device_idle)
    # the gap [R+1, R+20) is split between no span, the wrapper, its input copy and the core
    by_span = dict(out["idle_s_by_span"])
    assert by_span["ogp.sync.input_copy"] == pytest.approx(4 * 2e-6)
    assert by_span["ogp.sync.stencil_check"] == pytest.approx(4 * 2e-6)
    assert by_span["ogp.wiski_stream"] == pytest.approx(4 * 17e-6)


def test_syncs_are_counted_a_request():
    prof, tr = _reduced()
    out = spans.split(prof.events(), tr)
    assert out["host_syncs.absorb"] == 3.0
    assert out["sync_spans"] == ["ogp.sync.host_copy", "ogp.sync.input_copy", "ogp.sync.stencil_check"]
    assert out["device_waits_per_request"] == 13 / 4 and out["waits_outside_sync_spans"] == 1
    sp, _ = spans.counted_spans(spans.host_events(prof.events()), tr)
    assert {s.request for s in sp if s.name == "ogp.absorb"} == {12, 13, 14, 15}


def test_labels_name_the_innermost_span():
    prof, tr = _reduced()
    labels = dict(spans.split(prof.events(), tr)["idle_gaps"])
    assert labels["request: ogp.sync.stencil_check: cudaStreamSynchronize"] == pytest.approx(4 * 2e-6)
    assert labels["request: ogp.roots_stream: cudaLaunchKernel"] == pytest.approx(4 * 7e-6)
    assert labels["between requests: no span: python"] == pytest.approx(4 * 910e-6)


def test_without_program_spans_all_idle_is_the_harness_s():
    prof, tr = _reduced(with_spans=False)
    out = spans.split(prof.events(), tr)
    assert [out[name] for name, _, _ in spans.LAYERS] == [0.0, 0.0, 0.0]
    assert out["host_syncs.absorb"] == 0.0 and out["waits_outside_sync_spans"] == 13
    assert out["idle_no_span"] == pytest.approx(100 * (1 - trace.union_us(tr.kernels + tr.copies) / 4000))
