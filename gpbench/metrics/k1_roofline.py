"""K1 (``csrc/root_update.cu``, ``blocked_chunk``): its bound over its
device time per chunk, in %. A chunk is one launch of a recursion kernel,
over all the state's outputs (Bd); its time is the union of K1's kernels in
the counted part over the chunks."""

import math

from gpbench import counts
from gpbench.trace import count, kernel_time_us

KERNELS = ("chunk_gather_kernel", "chunk_recursion_", "chunk_apply_")


def read(ctx):
    t = ctx.trace
    chunks = count(t, ("chunk_recursion_",)) if t is not None else 0
    if not chunks or ctx.peaks is None:
        return None
    sizes = ctx.sizes
    work = counts.chunk_counts(ctx.outputs, math.prod(sizes), ctx.block, 4 ** len(sizes))
    bound = counts.bound_ms(*work, ctx.peaks)[0]
    return 100.0 * bound * 1e3 / (kernel_time_us(t, KERNELS) / chunks)
