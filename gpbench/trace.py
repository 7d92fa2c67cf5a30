"""The traced run: torch.profiler over the whole window, split into
requests by a marker kernel the harness launches before each request and
after the last, and reduced to what the per-layer readers take.

torch.profiler may lose the records of a window's first launches
(``profiler_records.py``), so the profile opens PAD_S before the first
request and the readers count only the requests after the first HEAD
share of the window (at least two).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import torch

PAD_S = 0.05
HEAD = 0.1
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
MARKER_CYCLES = 64

Interval = Tuple[float, float, str]  # start us, end us, name


def marker() -> None:
    torch.cuda._sleep(MARKER_CYCLES)


class Trace(NamedTuple):
    kernels: List[Interval]  # device kernels in the counted part, markers left out
    copies: List[Interval]  # device copies and fills in the counted part
    lo: float  # the counted part, us on the profiler's clock
    hi: float
    first: int  # the counted requests: record indices [first, last)
    last: int
    busy_s: float  # device activity over the whole window
    window_s: float
    device_ops: List[list]  # breakdown: the ten device operations that took most time
    idle_gaps: List[list]  # breakdown: idle time by what the host was doing

    def seconds(self) -> float:
        return (self.hi - self.lo) / 1e6


def union_us(intervals) -> float:
    """The time covered by the intervals, overlaps counted once."""
    total, end = 0.0, float("-inf")
    for s, e, *_ in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _merged(intervals) -> List[Tuple[float, float]]:
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(gap, host_starts, host, span_starts, spans) -> str:
    """What the host was doing in most of an idle gap: the leaf host
    operation that overlaps it most, and whether a request was open."""
    gs, ge = gap
    best, best_ov = None, 0.0
    i = bisect.bisect_left(host_starts, ge)
    for s, e, name in reversed(host[max(0, i - 16):i]):
        ov = min(e, ge) - max(s, gs)
        if ov > best_ov:
            best, best_ov = name, ov
    j = bisect.bisect_right(span_starts, gs) - 1
    inside = j >= 0 and spans[j][1] >= ge
    where = "request" if inside else "between requests"
    return f"{where}: {best}" if best else f"{where}: python"


def reduce(prof, first_request: int, window_s: float) -> Trace:
    """The Trace of a profiled window whose requests start at record index
    ``first_request``."""
    from torch.autograd import DeviceType

    device, host, spans, markers = [], [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if ev.name.startswith("gpbench."):  # the request span's annotation on the device's row
                continue
            (markers if MARKER in ev.name else device).append((s, e, ev.name))
        elif ev.name == "gpbench.request":
            spans.append((s, e, ev.name))
        elif not ev.cpu_children:
            host.append((s, e, ev.name))
    markers.sort()
    requests = len(markers) - 1
    if requests < 3:
        raise RuntimeError(f"the trace holds {len(markers)} request markers; at least 4 are needed")
    head = max(2, int(HEAD * requests))
    lo, hi = markers[head][0], markers[-1][0]
    whole = [iv for iv in device if markers[0][0] <= iv[0] <= markers[-1][1]]
    counted = [iv for iv in whole if lo <= iv[0] < hi]
    is_copy = lambda name: name.startswith(("Memcpy", "Memset"))  # noqa: E731
    kernels = [iv for iv in counted if not is_copy(iv[2])]
    copies = [iv for iv in counted if is_copy(iv[2])]

    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in whole:
        by_name[name] += (e - s) / 1e6
    device_ops = sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:10]

    host.sort()
    spans.sort()
    starts = [s for s, _, _ in host]
    span_starts = [s for s, _, _ in spans]
    gaps: Dict[str, float] = defaultdict(float)
    busy = _merged(counted)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge > gs:
            gaps[_label((gs, ge), starts, host, span_starts, spans)] += (ge - gs) / 1e6
    idle_gaps = sorted(([n, t] for n, t in gaps.items()), key=lambda x: -x[1])[:10]
    return Trace(kernels, copies, lo, hi, first_request + head, first_request + requests,
                 union_us(whole) / 1e6, window_s, device_ops, idle_gaps)


def profiled(fn):
    """Run fn() under torch.profiler (host and device), opened PAD_S before
    it; returns (profiler, fn's result)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        out = fn()
    return prof, out


def kernel_time_us(trace: Trace, prefixes) -> float:
    """Device time of the kernels whose names hold one of ``prefixes``,
    overlaps (programmatic dependent launch) counted once."""
    return union_us(iv for iv in trace.kernels if any(p in iv[2] for p in prefixes))


def count(trace: Trace, prefixes) -> int:
    return sum(1 for iv in trace.kernels if any(p in iv[2] for p in prefixes))
