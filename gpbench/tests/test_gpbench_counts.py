"""The benchmark's frozen operation and byte counts equal chip_smoke.py's,
and an op's count is worked out by hand."""

import pytest

from gpbench import counts, spec
from gpbench.traffic import Step

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


def test_absorb_op_counts_chunks_and_the_gram_products():
    m, k, P = 900, 128, 16
    chunk = counts.chunk_counts(1, m, k, P)[1]
    memo = {"caches": object()}
    assert spec.op("absorb").flops(Step("absorb", 0, 256), (30, 30), k, memo) == 2 * chunk + 256 * 2 * P * P
    assert "caches" not in memo
