"""The port's spans, on ``torch.profiler``'s clock, and its device-trace
window; the port of ``online_gp_tpu/logging/timing.py``.

:func:`span` marks one layer boundary of the program (the L5 wrapper's
entry points, the functional core's transforms, the stream loops) and
every place where the hot path waits on the card, named ``sync.<what>``.
While no profiler records it returns one shared no-op context, so a span
costs one flag read. While ``torch.profiler`` records, it opens a host
range ``ogp.<name>`` in the profiler's own timeline, beside the CUDA
kernels and copies, on the same clock; the profiler keeps the ranges in
memory and exports them when its window closes, each inside the span
that encloses it. :func:`profile_trace` records such a window.

The waits, ``ogp.sync.*``: ``stencil_check`` (the stream loops' range
check), ``host_copy`` (a tensor's inputs copied back into the replay
buffer), ``input_copy`` (a copy between the host and the card other than
a staged one), ``stage_reuse`` (a pinned slot whose copy is still in
flight), ``losses``, ``metrics``, ``replay_copy``, ``jitter_level``. A host
array bound for the card is staged in ``ogp.input_stage``, which does not
wait; ``api.regression.stage_host.staged_copies`` counts the arrays staged,
``stage_host.stage_waits`` the ``stage_reuse`` waits.

The ranges are ``RecordFunction``s of function scope, as the ATen
operators' own, not the user scope of ``torch.autograd.profiler.
record_function``: the profiler copies a user-scope range onto the
device's row as an annotation over the kernels launched inside it, and a
reduction of the trace that counts the device row's events as kernels
would count each span as one.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

PREFIX = "ogp."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``ogp.<name>`` while a profiler records, and
    does nothing otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(PREFIX + name)


def spanned(name: str):
    """Decorator form of :func:`span`: each call of the function is one span."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def _tensors(tree) -> Iterator[torch.Tensor]:
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for the device work that produces the tensors of ``tree``."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` window (CPU, and CUDA where a card is present)
    whose Chrome trace is written to ``<log_dir>/trace.json`` when it
    closes; yields the profiler (``key_averages()`` for sums by kernel).
    The program's spans, ``ogp.*``, are host ranges of that trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
