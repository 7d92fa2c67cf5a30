"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the kernels the cells' metrics read.

Frozen copies of ``chip_smoke.py``'s ``card_peaks``, ``bound_ms`` and
``chunk_bound`` (returned here as (bytes, operations) pairs), so that a
change to the program cannot move the bounds it is measured against. Each input byte counts once and each
output byte once. The operations count what the algorithm needs, not
what an implementation happens to do. Each op's ``flops``
(``gpbench/ops/<op>.py``) builds on these.
"""

from __future__ import annotations

# (device memory bytes/s, f32 flop/s outside the tensor cores): NVIDIA's
# data sheets, dense, at the full power limit (700 W on the SXM part)
PEAKS = {
    "H100 SXM": (3.35e12, 67e12),
    "H100 PCIe": (2.0e12, 51e12),
}


def card_peaks(name: str):
    """(part, (bytes/s, flop/s)) of the card named ``name``; raises for a
    part not in PEAKS (the SXM part reports itself as "NVIDIA H100 80GB HBM3")."""
    if "H100" not in name or "NVL" in name:
        raise ValueError(f"no peak rates for {name!r}; the bound needs one of {sorted(PEAKS)}")
    part = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return part, PEAKS[part]


def bound_ms(nbytes: float, flops: float, peaks):
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def chunk_counts(Bd, m, k, P):
    """K1, one chunk of k points: L and B read and written, the stencil
    read; the gather, the recursion (10 t m flops at step t) and the two
    rank-k applies."""
    return (4 * (4 * Bd * m * m + Bd * k * P + k * P),
            Bd * (2 * k * P * m + 5 * k * (k - 1) * m + 8 * m * m * k))


def gram_flops(P):
    """The Gram accumulator A += w w^T / noise of one point: P^2 products and sums."""
    return 2 * P * P
