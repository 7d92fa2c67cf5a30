"""Smoke run of the PyTorch/CUDA port (online_gp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises (exit code 1, no final ok line) on failure:

1. The card's name and power limit (nvidia-smi), TF32 off, and a build of
   every CUDA source under online_gp_torch/csrc with nvcc.
2. Each kernel (K2 rank1_apply, K1 blocked_chunk, K3 pred_chunk) against
   its plain PyTorch version on the card, on the same inputs, at m=900
   and k=128, for Bd=1 and Bd=2: K2 and one K1 chunk to 1e-5, a 4-chunk
   K1 stream to 2e-4, K3 to 2e-4 (allclose: |a-b| <= tol + tol*|b|).
   Each kernel's device time (torch.profiler, summed over its CUDA
   kernels, with each one's share), its wrapper's time between CUDA
   events (host issue included), its plain version's time, one PyTorch
   library call's (a yardstick the port never calls) and the least time
   the card could take for the same work. Then the host ops of 16
   single-point wiski_condition calls (where each one's time goes).
3. The WISKI serving path at the width of bench.py's configuration: 2-D
   inputs, a 30x30 grid (m=900), RBF, one output, learned second noise,
   256 seed points, slim state. wiski_stream of 16,384 points (K1), 256
   single-point wiski_condition calls (K2), prediction caches and
   predict on 1,024 held-out points, wiski_prequential_stream of 4,096
   points (K3 and K1). The launch counters are zeroed just before and
   read just after; each kernel must have launched. Gates: the stream's
   roots match the plain root update over a 256-point prefix to within
   1e-3 * scale (bench.py's gate), the predictions are finite, and the
   decomposition check's inverse_root_err is finite.

It prints the kernels as one JSON line, then the card's name and power
limit, and last {"ok": true, "device": {...}}. It needs a CUDA device
and exits non-zero without one.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models.wiski import (
    WiskiModel,
    wiski_check_decomposition,
    wiski_condition,
    wiski_init,
    wiski_predict,
    wiski_prediction_caches,
    wiski_prequential_stream,
    wiski_slim,
    wiski_stream,
)
from online_gp_torch.ops import _build
from online_gp_torch.ops.cuda_pred_stream import pred_chunk, pred_chunk_stencil_plain
from online_gp_torch.ops.cuda_root_update import (
    blocked_chunk,
    blocked_chunk_plain,
    rank1_apply,
    rank1_apply_plain,
)
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import dense_w, interp_coeffs
from online_gp_torch.ops.precision import assert_true_f32, f32_matmul_precision
from online_gp_torch.ops.pred_stream import pred_chunk_factors
from online_gp_torch.ops.root_update import (
    RootCache,
    blocked_factors,
    root_cache_update,
    stencil_rows,
)

SEED = 0
M_SIDE = 30  # bench.py: 30x30 grid, m = 900
K = 128  # chunk rank of wiski_stream and the prequential stream
N_SEED, N_STREAM, N_COND, N_TEST, N_PREQ = 256, 16384, 256, 1024, 4096
TIMING_REPS = 20

# (device memory bytes/s, f32 flop/s outside the tensor cores), NVIDIA data
# sheets, dense, at the full power limit
PEAKS = {
    "H100 SXM": (3.35e12, 67e12),
    "H100 PCIe": (2.0e12, 51e12),
}


def card_peaks(name: str):
    """The data-sheet peaks of the card; raises for a part not in PEAKS
    (the SXM part reports itself as e.g. "NVIDIA H100 80GB HBM3")."""
    if "H100" not in name or "NVL" in name:
        raise ValueError(f"no peak rates for {name!r}; the bound needs one of {sorted(PEAKS)}")
    part = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return part, PEAKS[part]


def bound_ms(nbytes: float, flops: float, peaks):
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, make_args, reps=TIMING_REPS):
    """Mean time of fn(*make_args()) between two CUDA events; the inputs
    are made fresh (outside the timed span) since the kernels update
    them in place. For a call of a few microseconds of device work this
    is the host's time to issue it, not the device's."""
    for _ in range(2):
        fn(*make_args())
    spans = []
    for _ in range(reps):
        args = make_args()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / reps


def device_ms(fn, make_args, kernels, reps=TIMING_REPS):
    """Mean device time per call of fn(*make_args()), summed over the named
    CUDA kernels from torch.profiler, and each kernel's share. The inputs
    are made fresh before each call, as in time_ms; the copies that makes
    are other kernels and are not counted. Raises unless every named
    kernel ran once a call."""
    from torch.profiler import ProfilerActivity, profile

    fn(*make_args())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*make_args())
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        for kname in kernels:
            if f"::{kname}(" in ev.key:
                if ev.count != reps:
                    raise AssertionError(f"{kname}: {ev.count} launches in {reps} calls")
                per_kernel[kname] = ev.self_device_time_total / reps / 1e3
    missing = set(kernels) - set(per_kernel)
    if missing:
        raise AssertionError(f"the profiler saw no device time for {sorted(missing)}")
    return sum(per_kernel.values()), per_kernel


def max_err(got, want, tol, what):
    """max |got - want| over the pairs; raises unless allclose at tol."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite kernel output")
        diff = (g - w).abs()
        worst = max(worst, float(diff.max()))
        if bool((diff > tol + tol * w.abs()).any()):
            raise AssertionError(f"{what}: max abs err {float(diff.max()):.3e} exceeds tol {tol:g}")
    return worst


def clone_all(*ts):
    return tuple(t.clone() for t in ts)


# --------------------------------------------------------------------------
# inputs at the main path's shapes
# --------------------------------------------------------------------------


def bench_model(dev):
    grid = Grid.create([(-1.1, 1.1)] * 2, M_SIDE, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    return model, model.init_params(2)


def synthetic_roots(rng, Bd, m, dev):
    """(L, B) of the well-conditioned A = W W^T/m + I, as the JAX package's
    kernel tests build them (tests/ops/test_pallas_batched.py)."""
    W = torch.tensor(rng.normal(size=(Bd, m, m)), device=dev)
    A = W @ W.mT / m + torch.eye(m, dtype=W.dtype, device=dev)
    L = torch.linalg.cholesky(A)
    B = torch.linalg.solve_triangular(L.mT, torch.eye(m, dtype=W.dtype, device=dev), upper=True)
    return L.float().contiguous(), B.float().contiguous()


def stencil(rng, grid, n, dev):
    x = torch.tensor(rng.uniform(-1, 1, (n, 2)), dtype=torch.float32, device=dev)
    idx, w = interp_coeffs(grid, x)
    return x, idx.to(torch.int32).contiguous(), w.contiguous()


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------


def check_rank1(rng, grid, peaks, dev):
    m = grid.num_points
    out = {}
    for Bd in (1, 2):
        L, B = synthetic_roots(rng, Bd, m, dev)
        _, idx, w = stencil(rng, grid, 1, dev)
        p = torch.einsum("p,bpm->bm", w[0], B[:, idx[0].long()]).contiguous()
        if Bd == 2:
            p[1] = 0.0  # p = 0 is an exact no-op
        want = rank1_apply_plain(L, B, p)
        got = rank1_apply(*clone_all(L, B), p)
        torch.cuda.synchronize()
        err = max_err(got, want, 1e-5, f"rank1_apply Bd={Bd}")
        if Bd == 2 and not (torch.equal(got[0][1], L[1]) and torch.equal(got[1][1], B[1])):
            raise AssertionError("rank1_apply: p = 0 changed the roots")

        def library(L, B, p):
            s2 = torch.sum(p * p, dim=-1)
            s = torch.sqrt(s2)
            u = p / torch.clamp(s, min=1e-20)[:, None]
            c, d = torch.sqrt(s2 + 1) - 1, 1 / torch.sqrt(s2 + 1) - 1
            for b in range(L.shape[0]):
                L[b].addr_(torch.mv(L[b], u[b]) * c[b], u[b])
                B[b].addr_(torch.mv(B[b], u[b]) * d[b], u[b])

        make = lambda: (*clone_all(L, B), p)
        nbytes = 4 * (4 * Bd * m * m + Bd * m)
        flops = Bd * (8 * m * m + 4 * m)
        bms, by = bound_ms(nbytes, flops, peaks)
        ms, stages = device_ms(rank1_apply, make, ("rank1_prepass_kernel", "rank1_rows_kernel"))
        out[Bd] = dict(
            max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(rank1_apply, make),
            plain_ms=time_ms(rank1_apply_plain, make), library_ms=time_ms(library, make),
            bound_ms=bms, bound_by=by,
        )
    return out


def plain_stream(L, B, idx, wv, k):
    for c in range(idx.shape[0] // k):
        L, B = blocked_chunk_plain(L, B, idx[c * k : (c + 1) * k], wv[:, c * k : (c + 1) * k])
    return L, B


def check_blocked_chunk(rng, grid, peaks, dev):
    m = grid.num_points
    out = {}
    for Bd in (1, 2):
        L, B = synthetic_roots(rng, Bd, m, dev)
        _, idx, w = stencil(rng, grid, 4 * K, dev)
        wv = (w[None] * torch.tensor([1.0, 1.3][:Bd], device=dev)[:, None, None]).contiguous()
        i1, wv1 = idx[:K].contiguous(), wv[:, :K].contiguous()
        want = blocked_chunk_plain(L, B, i1, wv1)
        got = blocked_chunk(*clone_all(L, B), i1, wv1)
        torch.cuda.synchronize()
        err = max_err(got, want, 1e-5, f"blocked_chunk Bd={Bd}")
        want_s = plain_stream(L, B, idx, wv, K)
        Lk, Bk = clone_all(L, B)
        for c in range(4):
            Lk, Bk = blocked_chunk(Lk, Bk, idx[c * K : (c + 1) * K].contiguous(), wv[:, c * K : (c + 1) * K].contiguous())
        torch.cuda.synchronize()
        err_stream = max_err((Lk, Bk), want_s, 2e-4, f"blocked_chunk 4-chunk stream Bd={Bd}")

        # the yardstick applies this chunk's U, P, R from the plain recursion
        U, Pm, R = blocked_factors(torch.einsum("bkp,bkpm->bkm", wv1, B[:, i1.long()]))

        def library(L, B):
            L.baddbmm_(torch.bmm(L, R.mT), U)
            B.baddbmm_(torch.bmm(B, Pm.mT), U)

        make = lambda: (*clone_all(L, B), i1, wv1)
        P = idx.shape[1]
        nbytes = 4 * (4 * Bd * m * m + Bd * K * P + K * P)
        flops = Bd * (2 * K * P * m + 5 * K * (K - 1) * m + 8 * m * m * K)
        bms, by = bound_ms(nbytes, flops, peaks)
        ms, stages = device_ms(blocked_chunk, make, (
            "chunk_gather_kernel", "chunk_recursion_kernel", "chunk_apply_t_kernel", "chunk_apply_x_kernel"))
        out[Bd] = dict(
            max_abs_err=err, stream_max_abs_err=err_stream, ms=ms, stages_ms=stages,
            wrapper_ms=time_ms(blocked_chunk, make), plain_ms=time_ms(blocked_chunk_plain, make),
            library_ms=time_ms(library, lambda: clone_all(L, B)), bound_ms=bms, bound_by=by,
        )
    return out


def check_pred_chunk(rng, grid, model, params, peaks, dev):
    m = grid.num_points
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), dtype=torch.float32, device=dev)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_init(model, x0, y0, torch.ones_like(y0))
    mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    out = {}
    for Bd in (1, 2):
        C = torch.cat([cov_cache, 0.9 * cov_cache])[:Bd].contiguous()
        mu = torch.cat([mean_cache[..., 0], -mean_cache[..., 0]])[:Bd].contiguous()
        x, idx, w = stencil(rng, grid, K, dev)
        y = (torch.sin(3 * x[:, 0])[None] * torch.tensor([1.0, 0.5][:Bd], device=dev)[:, None]).contiguous()
        nz = torch.ones((Bd, K), device=dev)
        want = pred_chunk_stencil_plain(C, mu, idx, w, y, nz)
        got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
        torch.cuda.synchronize()
        err = max_err(got, want, 2e-4, f"pred_chunk Bd={Bd}")

        # the yardstick applies this chunk's Z and r from the plain recursion
        S = stencil_rows(idx, w, m)
        Zf, rf, _, _ = pred_chunk_factors(S, S @ C, mu @ S.mT, y, nz)

        def library(C, mu):
            C.baddbmm_(Zf.mT, Zf, alpha=-1.0)
            mu.add_(torch.bmm(Zf.mT, rf[..., None])[..., 0])

        make = lambda: (*clone_all(C, mu), idx, w, y, nz)
        P = idx.shape[1]
        # C is symmetric, so C -= Z^T Z needs only its m (m + 1) / 2 distinct
        # entries read and written, at 2 k flops each (a SYRK)
        nbytes = 4 * (Bd * m * (m + 1) + 2 * Bd * m + 4 * Bd * K) + 8 * K * P
        flops = Bd * (2 * K * P * m + K * (K - 1) * m + m * (m + 1) * K + 2 * m * K)
        bms, by = bound_ms(nbytes, flops, peaks)
        ms, stages = device_ms(pred_chunk, make, ("pred_gather_kernel", "pred_recursion_kernel", "pred_apply_kernel"))
        out[Bd] = dict(
            max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(pred_chunk, make),
            plain_ms=time_ms(pred_chunk_stencil_plain, make),
            library_ms=time_ms(library, lambda: clone_all(C, mu)), bound_ms=bms, bound_by=by,
        )
    return out


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------


def plain_prefix_roots(model, roots, xs, ns):
    """bench.py's gate oracle: one plain dense rank-1 root update per point."""
    m = model.grid.num_points
    for i in range(xs.shape[0]):
        idx, w = interp_coeffs(model.grid, xs[i : i + 1], detach=True)
        v = dense_w(idx, w, m)[None] / torch.sqrt(torch.clamp(ns[i : i + 1], min=1e-7)).T[:, None, :]
        roots = root_cache_update(roots, v)
    return roots


def main_path(rng, model, params, card, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), **f32)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_slim(wiski_init(model, x0, y0, torch.ones_like(y0)))

    def points(n):
        x = torch.tensor(rng.uniform(-1, 1, (n, 2)), **f32)
        y = torch.sin(3 * x[:, :1])
        return x, y, torch.ones_like(y)

    xs, ys, ns = points(N_STREAM)
    xc, yc, nc = points(N_COND)
    xt, _, _ = points(N_TEST)
    xp, yp, npr = points(N_PREQ)
    gate_roots = RootCache(None, state.roots.root.clone(), state.roots.inv_root.clone())
    torch.cuda.synchronize()

    wrappers = (rank1_apply, blocked_chunk, pred_chunk)
    for wrapper in wrappers:
        wrapper.launches = 0
    t0 = time.perf_counter()
    state = wiski_stream(model, state, xs, ys, ns, block_size=K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(N_COND):
        state = wiski_condition(model, state, xc[i : i + 1], yc[i : i + 1], nc[i : i + 1])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    caches = wiski_prediction_caches(model, params, state)
    mean, var = wiski_predict(model, params, state, xt, caches=caches)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    state, caches, pm, pv = wiski_prequential_stream(model, params, state, caches, xp, yp, npr, block_size=K)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {w.__name__: w.launches for w in wrappers}

    print(f"main path on {card}:")
    print(f"  wiski_stream {N_STREAM} points, block {K}: {N_STREAM / (t1 - t0):.1f} updates/s ({t1 - t0:.4f} s)")
    print(f"  wiski_condition x{N_COND}: {N_COND / (t2 - t1):.1f} updates/s ({t2 - t1:.4f} s)")
    print(f"  prediction caches + predict {N_TEST} points: {t3 - t2:.4f} s")
    print(f"  wiski_prequential_stream {N_PREQ} points: {N_PREQ / (t4 - t3):.1f} points/s ({t4 - t3:.4f} s)")
    print(f"  kernel launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    if tuple(mean.shape) != (1, N_TEST) or tuple(var.shape) != (1, N_TEST):
        raise AssertionError(f"predict shapes {tuple(mean.shape)}, {tuple(var.shape)}")
    for name, t in [("mean", mean), ("var", var), ("pred_mean", pm), ("pred_var", pv)]:
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name}")
    rmse = float(torch.sqrt(torch.mean((mean[0] - torch.sin(3 * xt[:, 0])) ** 2)))
    preq_rmse = float(torch.sqrt(torch.mean((pm[0] - yp[:, 0]) ** 2)))
    print(f"  held-out RMSE vs sin(3 x0): {rmse:.6f}; prequential RMSE: {preq_rmse:.6f}")
    if not rmse < 0.1:
        raise AssertionError(f"held-out RMSE {rmse} is not below 0.1")

    # bench.py's gate: the blocked stream (K1) against the plain per-point
    # root update over a 256-point prefix
    n_check = 256
    checked = wiski_stream(model, state._replace(roots=RootCache(None, gate_roots.root.clone(), gate_roots.inv_root.clone())),
                           xs[:n_check], ys[:n_check], ns[:n_check], block_size=K)
    oracle = plain_prefix_roots(model, gate_roots, xs[:n_check], ns[:n_check])
    err = float((checked.roots.root - oracle.root).abs().max())
    scale = float(oracle.root.abs().max())
    inv_err = float((checked.roots.inv_root - oracle.inv_root).abs().max())
    print(f"  prefix gate: root err {err:.3e} (scale {scale:.3e}), inverse root err {inv_err:.3e}")
    if not err <= 1e-3 * max(scale, 1.0):
        raise AssertionError(f"stream/plain root drift {err:.3e} over {n_check} updates")
    check = wiski_check_decomposition(state)
    inv_root_err = float(check["inverse_root_err"].max())
    print(f"  wiski_check_decomposition inverse_root_err: {inv_root_err:.6e}")
    if not math.isfinite(inv_root_err):
        raise AssertionError("inverse_root_err is not finite")
    return launches


def profile_condition(rng, model, dev):
    """The host ops of a short per-point wiski_condition loop, from
    torch.profiler (its host time against its device time)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), dtype=torch.float32, device=dev)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_slim(wiski_init(model, x0, y0, torch.ones_like(y0)))
    n = 16
    xc = torch.tensor(rng.uniform(-1, 1, (n + 1, 2)), dtype=torch.float32, device=dev)
    yc = torch.sin(3 * xc[:, :1])
    state = wiski_condition(model, state, xc[n:], yc[n:], torch.ones_like(yc[n:]))
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for i in range(n):
            state = wiski_condition(model, state, xc[i : i + 1], yc[i : i + 1], torch.ones_like(yc[i : i + 1]))
        torch.cuda.synchronize()
    print(f"wiski_condition x{n}, host ops by self CPU time:")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi)
    part, peaks = card_peaks(name)
    print(f"peaks for the bound: {part} ({peaks[0]:.3g} B/s, {peaks[1]:.3g} f32 flop/s)")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    with f32_matmul_precision():
        assert_true_f32()
        print("TF32 off for matmuls and convolutions")
        build_s, logs = _build.build_all(verbose=True)
        print(f"kernel build: {build_s:.2f} s")
        for src, log in logs.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"  ptxas {src}: {line.strip()}")

        rng = np.random.default_rng(SEED)
        model, params = bench_model(dev)
        grid = model.grid
        card = f"{name} ({smi})"
        results = {
            "rank1_apply": check_rank1(rng, grid, peaks, dev),
            "blocked_chunk": check_blocked_chunk(rng, grid, peaks, dev),
            "pred_chunk": check_pred_chunk(rng, grid, model, params, peaks, dev),
        }
        for kname, by_bd in results.items():
            for Bd, r in by_bd.items():
                print(f"{kname} Bd={Bd} m={grid.num_points} k={K} on {card}: " + json.dumps(r))
        profile_condition(rng, model, dev)

        launches = main_path(rng, model, params, card, dev)

    meta = {
        "rank1_apply": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:264"),
        "blocked_chunk": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
        "pred_chunk": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
    }
    kernels = []
    for kname, (source, replaces) in meta.items():
        r = results[kname][1]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
