"""The program's spans in a traced window: the device's idle time split by
the port's layers, and the host's waits on the card counted where they
happen.

Under ``torch.profiler`` the port opens a host range ``ogp.<name>`` at each
layer boundary (``online_gp_torch.logging.timing``): ``ogp.absorb`` (the
L5 wrapper), ``ogp.wiski_stream`` (the functional core), ``ogp.roots_stream``
(the stream loop over K1's chunks), and ``ogp.sync.<what>`` around each
place where the host waits on the card. This module reads them from the
profile that ``trace.reduce`` reduces, on the same clock, over the same
counted part:

    python3 -m gpbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell's traced run (``run.run_cell``, as ``--trace 1`` does) and
prints its result line with one more key, ``spans`` (:func:`split`). It
measures on a CUDA device only.

Each idle instant of the counted part is put down to the innermost
program span open on the host at that instant, so one idle gap may be
split between spans. Idle while no program span is open is the harness's
(its loop and its markers). The shares of every chain of open spans add
up to ``device_idle``.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import DeviceType

from gpbench import run, spec, trace

PREFIX = "ogp."
SYNC = PREFIX + "sync."
REQUEST = "gpbench.request"
DEVICE_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# (metric, inside, outside): idle while the host is inside one span and outside another
LAYERS = (
    ("idle_wrapper.absorb", "ogp.absorb", "ogp.wiski_stream"),
    ("idle_core.absorb", "ogp.wiski_stream", "ogp.roots_stream"),
    ("idle_stream_loop.absorb", "ogp.roots_stream", None),
)

Chain = Tuple[str, ...]  # the program spans open at an instant, outermost first


class Span(NamedTuple):
    start: float  # us on the profiler's clock
    end: float
    name: str
    request: Optional[int]  # record index of the counted request whose span holds it


class Host(NamedTuple):
    """The host's side of a profile, each list (start, end, name) in start order."""

    spans: list  # the program's spans
    requests: list  # the harness's request spans
    waits: list  # CUDA runtime calls that wait on the device
    leaves: list  # host operations with no child (what ``trace.reduce`` labels gaps with)


def host_events(events) -> Host:
    ours, requests, waits, leaves = [], [], [], []
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            continue
        iv = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.name == REQUEST:
            requests.append(iv)
            continue
        if ev.name.startswith(PREFIX):
            ours.append(iv)
        elif ev.name in DEVICE_WAITS:
            waits.append(iv)
        if not ev.cpu_children:
            leaves.append(iv)
    return Host(sorted(ours), sorted(requests), sorted(waits), sorted(leaves))


def counted_spans(host: Host, tr: trace.Trace) -> Tuple[List[Span], List[Span]]:
    """The program's spans that overlap ``tr``'s counted part, and the
    device waits inside its counted requests, each with its request."""
    n = tr.last - tr.first
    counted = host.requests[len(host.requests) - n:] if n > 0 else []
    starts = [r[0] for r in counted]

    def request_of(s, e) -> Optional[int]:
        j = bisect.bisect_right(starts, s) - 1
        return tr.first + j if j >= 0 and e <= counted[j][1] else None

    spans = [Span(s, e, name, request_of(s, e)) for s, e, name in host.spans if e > tr.lo and s < tr.hi]
    waits = [Span(s, e, name, request_of(s, e)) for s, e, name in host.waits]
    return spans, [w for w in waits if w.request is not None]


def timeline(spans: List[Span], lo: float, hi: float) -> List[Tuple[float, float, Chain]]:
    """[lo, hi) cut at every edge of a span: (start, end, the chain open
    throughout). Spans nest, being ranges of one host thread; at a tie a
    span closes before the next opens."""
    spans = [s for s in spans if s.end > s.start]
    marks = sorted([(s.end, 0, i) for i, s in enumerate(spans)] + [(s.start, 1, i) for i, s in enumerate(spans)])
    out, open_, t = [], [], lo
    for at, opens, i in marks + [(hi, 0, None)]:
        a, b = max(t, lo), min(at, hi)
        if b > a:
            out.append((a, b, tuple(spans[j].name for j in open_)))
        t = max(t, at)
        if i is not None:
            (open_.append if opens else open_.remove)(i)
    return out


def idle_pieces(tr: trace.Trace, cuts) -> List[Tuple[float, float, Chain]]:
    """The counted part's idle intervals (no kernel or copy on the device)
    cut along ``cuts`` (:func:`timeline`)."""
    edges = [tr.lo] + [x for b in trace._merged(tr.kernels + tr.copies) for x in b] + [tr.hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out, j = [], 0
    for gs, ge in gaps:
        while j < len(cuts) and cuts[j][1] <= gs:
            j += 1
        k = j
        while k < len(cuts) and cuts[k][0] < ge:
            a, b = max(gs, cuts[k][0]), min(ge, cuts[k][1])
            if b > a:
                out.append((a, b, cuts[k][2]))
            k += 1
    return out


def idle_us(idle: Dict[Chain, float], inside: str, outside: Optional[str] = None) -> float:
    """Idle us while the host is inside a span named ``inside`` and outside
    any named ``outside``; ``idle`` maps each chain to its idle us."""
    return sum(t for chain, t in idle.items() if inside in chain and (outside is None or outside not in chain))


def split(events, tr: trace.Trace) -> Dict:
    """What the program's spans say of ``tr``'s counted part: each layer's
    idle share (% of the counted part, :data:`LAYERS`), the share with no
    program span open, the ``ogp.sync.*`` spans and the device waits a
    counted request, the waits outside every sync span, the idle seconds
    by innermost span, and ``trace.reduce``'s idle gaps with the innermost
    span in each label (``request: ogp.roots_stream: cudaLaunchKernel``)."""
    host = host_events(events)
    spans, waits = counted_spans(host, tr)
    pieces = idle_pieces(tr, timeline(spans, tr.lo, tr.hi))
    idle: Dict[Chain, float] = defaultdict(float)
    by_span: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    leaf_starts, request_starts = [s for s, _, _ in host.leaves], [s for s, _, _ in host.requests]
    for a, b, chain in pieces:
        inner = chain[-1] if chain else "no span"
        idle[chain] += b - a
        by_span[inner] += (b - a) / 1e6
        where, leaf = trace._label((a, b), leaf_starts, host.leaves, request_starts, host.requests).split(": ", 1)
        gaps[f"{where}: {inner}: {leaf}"] += (b - a) / 1e6
    whole, requests = tr.hi - tr.lo, tr.last - tr.first
    out = {name: 100.0 * idle_us(idle, inside, outside) / whole for name, inside, outside in LAYERS}
    out["idle_no_span"] = 100.0 * idle.get((), 0.0) / whole
    syncs = [s for s in spans if s.name.startswith(SYNC) and s.request is not None]
    out["host_syncs.absorb"] = len(syncs) / requests
    out["sync_spans"] = sorted({s.name for s in syncs})
    out["device_waits_per_request"] = len(waits) / requests
    out["waits_outside_sync_spans"] = sum(not any(s.start <= w.start and w.end <= s.end for s in syncs)
                                          for w in waits)
    out["idle_s_by_span"] = sorted(([n, t] for n, t in by_span.items()), key=lambda x: -x[1])
    out["idle_gaps"] = sorted(([n, t] for n, t in gaps.items()), key=lambda x: -x[1])[:10]
    return out


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = run.parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the spans are read from a CUDA device's trace; this machine has none", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    reduce, got = trace.reduce, {}

    def reduce_and_split(prof, first_request, window_s):
        tr = reduce(prof, first_request, window_s)
        got.update(split(prof.events(), tr))
        return tr

    trace.reduce = reduce_and_split
    try:
        out = run.run_cell(cell, args.seed, args.seconds, True, "cuda", t_start)
    finally:
        trace.reduce = reduce
    out.pop("numbers")
    out.pop("setup_phases")
    out["spans"] = got
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
