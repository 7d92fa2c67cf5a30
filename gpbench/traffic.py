"""The one generator of every traffic mix, and the closed loop that drives
the program with it.

A mix is a data file, ``gpbench/traffic/<mix>.json``:

  request          the steps of one request, in order: {"op": <name>,
                   "points": n}; each op is a file of its own,
                   ``gpbench/ops/<name>.py``, that drives the program and
                   replays the reference (``absorb`` takes the next n points
                   of the stream)
  sync_each        end every request in a device sync, and time it
  warmup_requests  requests run in set-up, before the window
  stream           the stream: inputs uniform on [low, high]^D, targets
                   amplitude * prod_d trig_d(freq[d] x_d) + noise_sd * N(0, 1)
                   (trig sin on even d, cos on odd); pool_points of them are
                   made in set-up and taken in order, from the start again
                   once used up. With ``classes`` (C), the targets are
                   integer labels instead: [-amplitude, amplitude] cut into
                   C equal bins, a target's label the number of inner edges
                   below it (C = 2: label 1 where the target is > 0)
  seed_points      the points the state is made from
  queries          a fixed query set (uniform like the stream's inputs) for
                   ops that predict
  check_requests   window requests with outputs, drawn from the seed (and
                   the last), whose outputs the check compares

Everything is drawn from the seed, on the device, in a few large calls.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from gpbench import spec


def check_mix(mix: Dict) -> None:
    for step in mix["request"]:
        spec.op(step["op"])  # raises for an op without a file


class Hypers(NamedTuple):
    """The kernel's and the likelihood's values, drawn from the seed and
    handed alike to the program and to the reference."""

    lengthscale: tuple  # (D,)
    outputscale: float
    noise: Optional[float]  # the learned second noise s2; None where the model has none


def draw_hypers(config: Dict, seed: int) -> Hypers:
    """Log-uniform draws in the configuration's ``hyper_ranges``; no second
    noise where they have no ``noise``."""
    rng = np.random.default_rng([seed, 1])
    r = config["hyper_ranges"]

    def draw(lo_hi):
        lo, hi = lo_hi
        return float(math.exp(rng.uniform(math.log(lo), math.log(hi))))

    ls = tuple(draw(r["lengthscale"]) for _ in range(config["input_dim"]))
    return Hypers(ls, draw(r["outputscale"]), draw(r["noise"]) if "noise" in r else None)


def _targets(x: torch.Tensor, stream: Dict, gen: torch.Generator) -> torch.Tensor:
    f = torch.full((x.shape[0],), float(stream["amplitude"]), dtype=x.dtype, device=x.device)
    for d, freq in enumerate(stream["freq"]):
        f = f * (torch.sin if d % 2 == 0 else torch.cos)(freq * x[:, d])
    noise = torch.randn(x.shape[0], generator=gen, dtype=x.dtype, device=x.device)
    return f + stream["noise_sd"] * noise


def _labels(y: torch.Tensor, stream: Dict) -> torch.Tensor:
    a, classes = float(stream["amplitude"]), stream["classes"]
    edges = torch.linspace(-a, a, classes + 1, dtype=y.dtype, device=y.device)[1:-1]
    return torch.sum(y[..., None] > edges, dim=-1)


def _inputs(n: int, dim: int, stream: Dict, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand((n, dim), generator=gen, dtype=torch.float32, device=device)
    return stream["low"] + (stream["high"] - stream["low"]) * u


class Inputs(NamedTuple):
    """What the benchmark hands the program (and, once the window has
    closed, the reference): host arrays of float32, the labels of a
    labelled stream int64."""

    seed_x: np.ndarray  # (seed_points, D)
    seed_y: np.ndarray  # (seed_points, 1) targets or labels
    pool_x: np.ndarray  # (pool_points, D)
    pool_y: np.ndarray  # (pool_points, 1) targets or labels
    queries: np.ndarray  # (queries, D)
    queries_dev: torch.Tensor  # the query set on the device


def make_inputs(mix: Dict, dim: int, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device).manual_seed(seed)
    s = mix["stream"]
    n_seed, n_pool, n_q = mix["seed_points"], mix["pool_points"], max(mix["queries"], 1)
    x = _inputs(n_seed + n_pool + n_q, dim, s, gen, device)
    y = _targets(x[: n_seed + n_pool], s, gen)[:, None]
    if "classes" in s:
        y = _labels(y, s)
    xh, yh = x.cpu().numpy(), y.cpu().numpy()
    q = x[n_seed + n_pool:]
    return Inputs(xh[:n_seed], yh[:n_seed], xh[n_seed:n_seed + n_pool], yh[n_seed:],
                  xh[n_seed + n_pool:], q.contiguous())


class Step(NamedTuple):
    op: str
    start: int  # pool offset of the step's stream points (0 where it takes none)
    n: int


class Stream:
    """The cursor over the pool: a step that takes stream points takes the
    next n, from the start again once the pool is used up."""

    def __init__(self, inputs: Inputs):
        self.inputs = inputs
        self.pos = 0

    def take(self, n: int) -> int:
        if n > len(self.inputs.pool_x):
            raise ValueError(f"a step of {n} points is longer than the pool ({len(self.inputs.pool_x)})")
        if self.pos + n > len(self.inputs.pool_x):
            self.pos = 0
        start, self.pos = self.pos, self.pos + n
        return start


class Record:
    """What the loop did: the steps of every request in order, the outputs
    of its steps that return some, and, where the mix syncs each request,
    each request's seconds."""

    def __init__(self):
        self.requests: List[List[Step]] = []
        self.outputs: List[Dict[int, tuple]] = []  # per request: step index -> outputs
        self.seconds: List[float] = []


def run_request(wrapper, mix: Dict, stream: Stream, record: Record) -> None:
    """Issue one request's steps to the wrapper, each through its op."""
    steps, outs = [], {}
    for i, step in enumerate(mix["request"]):
        done, out = spec.op(step["op"]).run(wrapper, step, stream)
        steps.append(done)
        if out is not None:
            outs[i] = out
    record.requests.append(steps)
    record.outputs.append(outs)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drive(wrapper, mix: Dict, stream: Stream, record: Record, seconds: float, device, marker=None) -> float:
    """The closed loop with one caller: requests back to back until
    ``seconds`` have passed, each ended in a sync and timed when the mix
    asks for it, then one sync. ``marker`` (traced runs) is called before
    each request and once after the last, and each request is a profiler
    span ``gpbench.request``. Returns the window's seconds."""
    sync_each = mix["sync_each"]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    now = t0
    while now < deadline:
        if marker is None:
            run_request(wrapper, mix, stream, record)
        else:
            marker()
            with torch.autograd.profiler.record_function("gpbench.request"):
                run_request(wrapper, mix, stream, record)
        if sync_each:
            sync(device)
            t1 = time.perf_counter()
            record.seconds.append(t1 - now)
            now = t1
        else:
            now = time.perf_counter()
    if marker is not None:
        marker()
    sync(device)
    return time.perf_counter() - t0


def points_of(steps: List[Step], ops=("absorb",)) -> int:
    return sum(s.n for s in steps if s.op in ops)
