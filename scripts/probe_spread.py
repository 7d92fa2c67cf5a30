"""Hold K1's and K3's recursions past their cluster envelopes (spread over
the card) against their plain versions and time them, and each spread
layout against the others, in one process on one card.

    python3 scripts/probe_spread.py [--out FILE]

For each (k, m) below, K1's ``chunk_factors`` (and K3's ``pred_factors``)
on random inputs made on the card from one seed: the wrapper's route (the
plan), its largest difference from the plain recursion (over the scale
max(max |plain|, 1)), whether a second call gives the same bits, and its
time between CUDA events (mean of 5 calls after one). At k = 128,
m = 16,384 each spread layout the card holds (3, 1, 0 slices of K1's U,
P, R in shared memory; 2, 1, 0 of K3's Z and stencil) runs on the same
inputs through the C entry, at the most clusters the card holds of it. One JSON line a shape, the card's name and power limit
first.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from online_gp_torch.ops import _build  # noqa: E402
from online_gp_torch.ops import cuda_pred_stream as tcps  # noqa: E402
from online_gp_torch.ops import cuda_root_update as tcru  # noqa: E402
from online_gp_torch.ops.precision import f32_matmul_precision  # noqa: E402
from online_gp_torch.ops.root_update import stencil_rows  # noqa: E402

K1_SHAPES = [(128, 4481), (128, 8961), (128, 16384), (128, 32400), (128, 46656), (128, 65536), (1024, 1200),
             (1024, 4000), (1024, 20000), (512, 3000), (32, 28000)]
K3_SHAPES = [(128, 6017, 16), (512, 900, 16), (128, 16384, 16), (128, 57855, 16), (128, 65536, 16),
             (512, 900, 64), (1024, 900, 16), (1024, 5000, 16), (32, 50000, 16)]
REPS = 5
dev = torch.device("cuda", 0)


def ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def events_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scaled(got, want):
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1.0) for g, w in zip(got, want))


def k1_entry(lib, p0, G, spread):
    """ogp_chunk_factors spread over G clusters of 8 with ``spread`` slices
    in shared memory."""
    Bd, k, m = p0.shape
    U, Pm, R = torch.empty((3, Bd, k, m), device=dev)
    slots = torch.zeros((Bd, 2, G, k + 1), dtype=torch.int64, device=dev)
    rc = lib.ogp_chunk_factors(ptr(p0), ptr(U), ptr(Pm), ptr(R), ptr(slots), Bd, k, m, G, Bd, 8, spread, None)
    if rc:
        raise RuntimeError(f"ogp_chunk_factors: {rc}")
    return U, Pm, R


def k3_entry(lib, idx, w, c0w, mu0w, y, nz, G, spread):
    """ogp_pred_factors spread over G clusters of 8 with ``spread`` of Z
    and the stencil in shared memory."""
    Bd, k, m = c0w.shape
    Z = torch.empty((Bd, k, m), device=dev)
    vecs = torch.empty((3, Bd, k), device=dev)
    slots = torch.zeros((Bd, 2, G, k + 1), dtype=torch.int64, device=dev)
    rc = lib.ogp_pred_factors(ptr(idx), ptr(w), ptr(c0w), ptr(mu0w), ptr(y), ptr(nz), ptr(Z), ptr(vecs[0]),
                              ptr(vecs[1]), ptr(vecs[2]), ptr(slots), Bd, k, idx.shape[1], m, 8, G, Bd, spread, None)
    if rc:
        raise RuntimeError(f"ogp_pred_factors: {rc}")
    return Z, vecs[0], vecs[1], vecs[2]


def largest_g(capacity):
    """The most clusters (<= 16) a layout's capacity query allows."""
    return max((G for G in range(1, 17) if capacity(G) >= G), default=0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lines = []
    g = torch.Generator(device=dev).manual_seed(0)
    with f32_matmul_precision():
        _build.build_all()
        lib, plib = tcru._root_update_lib(), tcps._pred_stream_lib()
        for k, m in K1_SHAPES:
            p0 = (torch.randn((1, k, m), generator=g, device=dev) / m**0.5).contiguous()
            plan = _build.route(lib, tcru.K1, 1, k, m, dev).plan
            want = tcru.chunk_factors_plain(p0)
            got, again = tcru.chunk_factors(p0), tcru.chunk_factors(p0)
            torch.cuda.synchronize()
            row = dict(kernel="K1", k=k, m=m, plan=str(plan), err=scaled(got, want),
                       bitwise=all(torch.equal(a, b) for a, b in zip(got, again)),
                       ms=events_ms(lambda: tcru.chunk_factors(p0)))
            if (k, m) == (128, 16384):
                for sl in (3, 1, 0):
                    G = largest_g(lambda G: lib.ogp_chunk_spread_capacity(k, m, 8, G, sl))
                    got = k1_entry(lib, p0, G, sl)
                    row[f"slices{sl}"] = dict(G=G, err=scaled(got, want), ms=events_ms(lambda: k1_entry(lib, p0, G, sl)))
            print(json.dumps(row), flush=True)
            lines.append(row)
            del p0, want, got, again
        for k, m, P in K3_SHAPES:
            idx = torch.randint(0, m, (k, P), generator=g, device=dev, dtype=torch.int32)
            w = torch.rand((k, P), generator=g, device=dev)
            w = (w / w.sum(1, keepdim=True)).contiguous()
            S = stencil_rows(idx, w, m)
            G64 = torch.randn((1, m, 64), generator=g, device=dev)
            # c0w = S C for C = 0.1 I + G G^T / 64, without forming C
            c0w = (0.1 * S[None] + ((S @ G64) @ G64.mT) / 64).contiguous()
            mu0w = (torch.randn((1, m), generator=g, device=dev) @ S.mT).contiguous()
            y = torch.randn((1, k), generator=g, device=dev)
            nz = torch.ones((1, k), device=dev)
            fargs = (idx, w, c0w, mu0w, y, nz)
            plan = _build.route(plib, tcps.K3, 1, k, m, dev, P).plan
            want = tcps.pred_factors_plain(*fargs)
            got, again = tcps.pred_factors(*fargs), tcps.pred_factors(*fargs)
            torch.cuda.synchronize()
            row = dict(kernel="K3", k=k, m=m, P=P, plan=str(plan), err=scaled(got, want),
                       bitwise=all(torch.equal(a, b) for a, b in zip(got, again)),
                       ms=events_ms(lambda: tcps.pred_factors(*fargs)))
            if (k, m) == (128, 16384):
                for sl in (2, 1, 0):
                    G = largest_g(lambda G: plib.ogp_pred_spread_capacity(k, m, P, 8, G, sl))
                    got = k3_entry(plib, *fargs, G, sl)
                    row[f"slices{sl}"] = dict(G=G, err=scaled(got, want),
                                              ms=events_ms(lambda: k3_entry(plib, *fargs, G, sl)))
            print(json.dumps(row), flush=True)
            lines.append(row)
            del c0w, want, got, again, S, G64
    if args.out:
        args.out.write_text("\n".join(json.dumps(r) for r in [dict(card=smi), *lines]) + "\n")


if __name__ == "__main__":
    main()
