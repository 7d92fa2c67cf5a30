"""Points absorbed in the window's absorb steps over the window's seconds."""

from gpbench.traffic import points_of


def read(ctx):
    n = sum(points_of(steps, ("absorb",)) for steps in ctx.record.requests[ctx.first:])
    return n / ctx.window_s if n else None
