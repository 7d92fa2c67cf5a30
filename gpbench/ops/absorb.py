"""A step ``{"op": "absorb", "points": n}``: the wrapper's ``absorb()`` of the
stream's next n points, handed over as host arrays (the targets, or the
labels of a labelled stream, as the pool holds them)."""

from __future__ import annotations

import math

from gpbench import counts
from gpbench.traffic import Step


def run(wrapper, step, stream):
    """Drive the program; returns (the step done, its outputs or None)."""
    n = step["points"]
    start = stream.take(n)
    inp = stream.inputs
    wrapper.absorb(inp.pool_x[start:start + n], inp.pool_y[start:start + n])
    return Step("absorb", start, n), None


def replay(ref, done: Step, inputs, keep: bool):
    """Drive the reference (``check.Replay``) through the same step; returns
    its outputs where ``keep``, or None. The reference takes a labelled
    stream's Dirichlet targets and noises (``check.Replay.observed``)."""
    ref.absorb(inputs.pool_x[done.start:done.start + done.n], inputs.pool_y[done.start:done.start + done.n])
    return None


def flops(done: Step, sizes, block: int, outputs: int, memo: dict) -> float:
    """The operations the step needs: a K1 chunk of the state's ``outputs``
    for every ``block`` points and each output's Gram accumulator product of
    each point. It drops the caches."""
    memo.pop("caches", None)
    m, P = math.prod(sizes), 4 ** len(sizes)
    return (done.n / block * counts.chunk_counts(outputs, m, block, P)[1]
            + outputs * done.n * counts.gram_flops(P))
