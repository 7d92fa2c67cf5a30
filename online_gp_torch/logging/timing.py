"""Wall-clock span timing (the reference's only tracing facility:
``time.time()`` spans logged as ``step_time``) plus a ``torch.profiler``
hook for device traces; the port of ``online_gp_tpu/logging/timing.py``.

A span given ``block_on`` waits for the device work behind it before the
clock stops (``torch.cuda.synchronize`` on each CUDA device its tensors lie
on; nothing for CPU tensors), so it measures execution, not dispatch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List

import torch


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


class Timer:
    """Accumulates named wall-clock spans."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def last(self, name: str) -> float:
        return self.spans[name][-1]

    def total(self, name: str) -> float:
        return sum(self.spans.get(name, []))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` window (CPU, and CUDA where a card is present)
    whose Chrome trace is written to ``<log_dir>/trace.json`` when it
    closes; yields the profiler (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
