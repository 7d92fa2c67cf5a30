"""Kernel launches in the counted part of the traced window (copies,
fills and the harness's markers left out) over the points its requests
absorbed."""

from gpbench.traffic import points_of


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    points = sum(points_of(steps) for steps in ctx.record.requests[t.first:t.last])
    return len(t.kernels) / points if points else None
