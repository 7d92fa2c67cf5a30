"""How often torch.profiler misses a kernel's launch record, against the
time the profile window is open before its first launch.

    python3 profiler_records.py [--windows N]   # from the repository root

Needs a CUDA card. For K3 (pred_chunk), K2 (rank1_apply) and the row-shard
stages of K1 and K3 that run their own short kernels (chunk_gather_rows,
chunk_apply_rows, pred_gather_rows, pred_apply_rows on rows [0, 450)) at
m = 900, k = 128, Bd = 1, it profiles N windows of chip_smoke.TIMING_REPS calls
each (chip_smoke.device_ms runs PROFILE_EXTRA_CALLS more first and counts
the last TIMING_REPS), with each pad in PADS_S between the
window's start and its first launch. For each kernel and pad it prints one
JSON line: the windows that recorded fewer launches than were made, and
for each such window the first call (0-based) and kernel whose record is
missing, from the order of the records in time.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import chip_smoke as cs
from online_gp_torch.ops.cuda_pred_stream import (
    pred_apply_rows,
    pred_chunk,
    pred_factors,
    pred_gather_rows,
)
from online_gp_torch.ops.cuda_root_update import chunk_apply_rows, chunk_factors, chunk_gather_rows, rank1_apply
from online_gp_torch.ops.precision import f32_matmul_precision

PADS_S = (0.0, 0.01, cs.PROFILE_PAD_S)


def first_gap(prof, kernels, reps):
    """(call, kernel) of the first launch without a record, or None."""
    names = list(kernels)
    seen = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        hit = [k for k in names if f"::{k}(" in ev.name]
        if hit:
            seen.append(hit[0])
    want = names * reps
    for i, k in enumerate(want):
        if i >= len(seen) or seen[i] != k:
            return i // len(names), k
    return None


def count_misses(fn, make_args, kernels, windows, pad_s):
    fn(*make_args())
    torch.cuda.synchronize()
    misses = []
    for _ in range(windows):
        prof, records = cs.profile_window(fn, make_args, kernels, cs.TIMING_REPS, pad_s=pad_s)
        short = {k: n for k, (n, _) in records.items() if n != cs.TIMING_REPS * kernels[k]}
        if short:
            misses.append({"records": short, "first_gap": first_gap(prof, kernels, cs.TIMING_REPS)})
    return misses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line())
    with f32_matmul_precision():
        rng = np.random.default_rng(cs.SEED)
        model, _ = cs.bench_model(dev)
        grid = model.grid
        L, B = cs.synthetic_roots(rng, 1, grid.num_points, dev)
        _, idx1, w1 = cs.stencil(rng, grid, 1, dev)
        p = torch.einsum("p,bpm->bm", w1[0], B[:, idx1[0].long()]).contiguous()
        C = (B @ B.mT).contiguous()
        mu = torch.zeros((1, grid.num_points), device=dev)
        x, idx, w = cs.stencil(rng, grid, cs.K, dev)
        y = torch.sin(3 * x[:, 0])[None].contiguous()
        nz = torch.ones((1, cs.K), device=dev)
        recursion = cs.k3_route(cs.K, grid.num_points, idx.shape[1], "cluster")[1]
        m = grid.num_points
        rows = m // 2
        Lr, Br, Cr, mur = (t[:, :rows].contiguous() for t in (L, B, C, mu))
        wv = w[None].contiguous()
        U, Pm, R = chunk_factors(chunk_gather_rows(B, idx, wv, 0))
        Z, r, _, _ = pred_factors(idx, w, *pred_gather_rows(C, mu, idx, w, 0), y, nz)
        cases = {
            "pred_chunk": (pred_chunk, lambda: (C.clone(), mu.clone(), idx, w, y, nz),
                           {"pred_gather_kernel": 1, recursion: 1, **cs.k3_apply_kernels(1, m, m)}),
            "rank1_apply": (rank1_apply, lambda: (L.clone(), B.clone(), p),
                            {"rank1_prepass_kernel": 1, "rank1_rows_kernel": 1}),
            "chunk_gather_rows": (chunk_gather_rows, lambda: (Br, idx, wv, 0), {"chunk_gather_kernel": 1}),
            "chunk_apply_rows": (chunk_apply_rows, lambda: (Lr.clone(), Br.clone(), U, Pm, R),
                                 cs.k1_apply_kernels(cs.K, rows, m)),
            "pred_gather_rows": (pred_gather_rows, lambda: (Cr, mur, idx, w, 0), {"pred_gather_kernel": 1}),
            "pred_apply_rows": (pred_apply_rows, lambda: (Cr.clone(), mur.clone(), Z, r, 0),
                                cs.k3_apply_kernels(1, rows, m)),
        }
        for name, (fn, make, kernels) in cases.items():
            for pad_s in PADS_S:
                misses = count_misses(fn, make, kernels, args.windows, pad_s)
                print(json.dumps({"kernel": name, "pad_s": pad_s, "windows": args.windows,
                                  "calls_per_window": cs.TIMING_REPS, "windows_short": len(misses),
                                  "misses": misses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
