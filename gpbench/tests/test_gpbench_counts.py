"""The benchmark's frozen operation and byte counts equal chip_smoke.py's,
an op's count is worked out by hand, and the counts that read K1's batch
take it from the configuration's ``num_outputs``."""

import math

import pytest

from gpbench import counts, run, spec
from gpbench.trace import Trace
from gpbench.traffic import Record, Step

cs = pytest.importorskip("chip_smoke")
PEAKS = counts.PEAKS["H100 SXM"]
SHAPES = [(1, 256, 128, 16), (1, 900, 128, 16), (1, 4096, 128, 16), (2, 256, 64, 16), (1, 16384, 128, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_chunk_counts_are_chip_smokes(shape):
    assert counts.bound_ms(*counts.chunk_counts(*shape), PEAKS) == cs.chunk_bound(*shape, PEAKS)


def test_peaks_are_chip_smokes():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"):
        assert counts.card_peaks(name) == cs.card_peaks(name)


def test_chunk_count_by_hand():
    # m = 6, k = 2, P = 4: the gather 2 k P m = 96, the recursion
    # 5 k (k - 1) m = 60, the two applies 8 m^2 k = 576; bytes: L and B
    # read and written 4 m^2 floats, the stencil's indices and weights 2 k P
    assert counts.chunk_counts(1, 6, 2, 4) == (4 * (4 * 36 + 2 * 2 * 4), 96 + 60 + 576)


def test_chunk_count_of_two_outputs_by_hand():
    # Bd = 2, m = 6, k = 2, P = 4: each output's gather 96, recursion 60 and
    # applies 576; bytes: both outputs' L and B (2 x 4 m^2 floats), both
    # outputs' scaled stencil weights (2 k P) and the shared indices (k P)
    assert counts.chunk_counts(2, 6, 2, 4) == (4 * (2 * 4 * 36 + 2 * 2 * 4 + 2 * 4), 2 * (96 + 60 + 576))


@pytest.mark.parametrize("outputs", [1, 2])
def test_absorb_op_counts_chunks_and_the_gram_products(outputs):
    m, k, P = 900, 128, 16
    chunk = counts.chunk_counts(outputs, m, k, P)[1]
    memo = {"caches": object()}
    got = spec.op("absorb").flops(Step("absorb", 0, 256), (30, 30), k, outputs, memo)
    assert got == 2 * chunk + outputs * 256 * 2 * P * P
    assert "caches" not in memo


def _ctx(outputs: int) -> run.Context:
    """A traced absorb of 4 requests of 4,096 points at m = 256: 128 chunks,
    each of K1's three kernels 10 us a chunk, the counted part 0.1 s."""
    kernels = []
    for c in range(128):
        t = 1000.0 * c
        kernels += [(t, t + 10, "chunk_gather_kernel"), (t + 10, t + 20, "chunk_recursion_cluster_kernel"),
                    (t + 20, t + 30, "chunk_apply_cluster_kernel")]
    tr = Trace(kernels, [], 0.0, 1e5, 0, 4, 0.0384, 0.1, [], [])
    record = Record()
    record.requests = [[Step("absorb", 4096 * r, 4096)] for r in range(4)]
    cell = spec.load_cell("grid16-absorb")
    return run.Context(cell, record, 0, 0.1, 1.0, tr, counts.PEAKS["H100 SXM"], (16, 16), 128, outputs)


@pytest.mark.parametrize("outputs", [1, 2])
def test_k1_roofline_and_mfu_count_the_state_s_outputs(outputs):
    ctx = _ctx(outputs)
    bound_ms = counts.bound_ms(*counts.chunk_counts(outputs, 256, 128, 16), ctx.peaks)[0]
    assert spec.reader("k1_roofline.absorb")(ctx) == 100.0 * bound_ms * 1e3 / 30.0
    flops = 4 * (32 * counts.chunk_counts(outputs, 256, 128, 16)[1] + outputs * 4096 * 2 * 16 * 16)
    assert spec.reader("mfu.absorb")(ctx) == pytest.approx(100.0 * flops / (0.1 * ctx.peaks[1]), rel=1e-12)
    if outputs == 2:  # twice the work in the same time: the operations bound K1 at m = 256
        assert spec.reader("mfu.absorb")(ctx) == pytest.approx(2 * spec.reader("mfu.absorb")(_ctx(1)), rel=1e-12)
        assert math.isclose(spec.reader("k1_roofline.absorb")(ctx), 2 * spec.reader("k1_roofline.absorb")(_ctx(1)))
