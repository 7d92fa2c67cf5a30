"""The share of the counted part of the traced window in which no kernel,
copy or fill ran on the device, in %."""

from gpbench.trace import union_us


def read(ctx):
    t = ctx.trace
    if t is None or t.hi <= t.lo:
        return None
    return 100.0 * (1.0 - union_us(t.kernels + t.copies) / (t.hi - t.lo))
