"""Randomness helpers (reference ``online_gp/utils/random.py``; the port of
``online_gp_tpu/utils/random.py``, a ``torch.Generator`` where JAX takes a
key)."""

from __future__ import annotations

from typing import Optional

import torch


def shuffle_tensors(*tensors, generator: Optional[torch.Generator] = None, seed: int = 0):
    """Shuffle tensors along their first dimension with one shared
    permutation (reference ``shuffle_tensors``, utils/random.py:4-8), drawn
    from ``generator`` (a CPU generator seeded with ``seed`` by default).
    Returns one tensor for one input, else a tuple."""
    generator = torch.Generator().manual_seed(seed) if generator is None else generator
    tensors = [torch.as_tensor(t) for t in tensors]
    n = tensors[0].shape[0]
    if any(t.shape[0] != n for t in tensors):
        raise ValueError("shuffle_tensors needs tensors of one length")
    perm = torch.randperm(n, generator=generator, device=generator.device)
    out = tuple(t[perm.to(t.device)] for t in tensors)
    return out[0] if len(out) == 1 else out
