"""The whole step's share of the card's float32 peak, in %: the operations
the counted requests need (each step's op's ``flops``, on
``gpbench.counts``) over the counted part's seconds times the peak."""

from gpbench import spec


def request_flops(requests, sizes, block, outputs):
    """Operations of each request, in order from the run's first."""
    memo, out = {}, []
    for steps in requests:
        out.append(sum(spec.op(st.op).flops(st, sizes, block, outputs, memo) for st in steps))
    return out


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    flops = sum(request_flops(ctx.record.requests, ctx.sizes, ctx.block, ctx.outputs)[t.first:t.last])
    return 100.0 * flops / (t.seconds() * ctx.peaks[1])
