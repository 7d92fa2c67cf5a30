"""Smoke run of the PyTorch/CUDA port (online_gp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises (exit code 1, no final ok line) on failure:

1. The card's name and power limit (nvidia-smi), TF32 off, and a build of
   every CUDA source under online_gp_torch/csrc with nvcc.
2. Each kernel (K2 rank1_apply, K1 blocked_chunk, K3 pred_chunk) against
   its plain PyTorch version on the card, on the same inputs, at m=900
   and k=128, for Bd=1 and Bd=2: K2 and one K1 chunk to 1e-5, a 4-chunk
   K1 stream to 2e-4, K3 to 2e-4 (allclose: |a-b| <= tol + tol*|b|); K1
   and K3 bitwise the same on a second call. Outside the cluster
   envelope, on the single-block recursion kernels: one K1 chunk at
   m=2,500 (a 50x50 grid) to 1e-5 and one K3 chunk of k=512 at m=900 to
   2e-4. Each kernel's device time (torch.profiler, summed over its CUDA
   kernels, with each one's share), its wrapper's time between CUDA
   events (host issue included), its plain version's time, one PyTorch
   library call's (a yardstick the port never calls) and the least time
   the card could take for the same work. The K1 and K3 cluster
   recursions are rows of their own: their device time within the chunk,
   the plain recursion's time, their bound, and the chunk's error (the
   wrappers return no factors). Then the host ops of 16 single-point
   wiski_condition calls.
3. The WISKI serving path at the width of bench.py's configuration: 2-D
   inputs, a 30x30 grid (m=900), RBF, one output, learned second noise,
   256 seed points, slim state. wiski_stream of 16,384 points (K1), 256
   single-point wiski_condition calls (K2) and prediction caches (Q on K6)
   plus predict on 1,024 held-out points, each of these two host-bound
   metrics 7 times after a warm-up (median and min-max spread),
   wiski_prequential_stream of 4,096 points (K3 and K1). The launch
   counters are zeroed just before and read just after; each kernel must
   have launched, every K1 and K3 chunk with its recursion on a cluster. Then a short profiled pass of both
   streams: torch.profiler must record the cluster recursion kernels and
   no single-block recursion. Gates: the stream's
   roots match the plain root update over a 256-point prefix to within
   1e-3 * scale (bench.py's gate), the predictions are finite, and the
   decomposition check's inverse_root_err is finite.
4. The remaining kernels' entry points at m=900, fed from WISKI states of
   phase 3's model. The launch counters are zeroed just before and read
   just after this path:
   - K4 (fused_root_cache_update): 256 single-point dense-v updates
     v = W_x/sqrt(noise) on full wiski_init states at Bd=1 and Bd=2 and on
     the slim Bd=1 state, against the plain root_cache_update: roots within
     1e-3 * scale, A to 1e-5, wiski_check_decomposition's errors finite.
   - K5 (blocked_chunk with sub=32 and with mode="coord"): a 4-chunk stream
     of k=128 on phase 3's final roots, against blocked_chunk_plain with
     the same options, to 2e-4; every sub chunk on the fused cluster kernel.
   - K6 (blocked_cholesky): Q = I + L^T Kuu_hat L of phase 3's final state,
     against its plain version and torch.linalg.cholesky: relative max
     error <= 5e-4, strict upper triangle exactly 0.
   Then each kernel against its plain version on synthetic inputs, with
   times as in phase 2: K4 one update to 1e-5 and bitwise the same on a
   second call (Bd=1, Bd=2 with p=0 an exact no-op, slim Bd=1; and one at
   m=1,100, where the row kernel loops over a row); K5 one
   chunk to 1e-5, bitwise the same on a second call, and a 4-chunk stream
   to 2e-4 at Bd=1 and 2, with each variant's distance to flat K1 and K1
   flat's device time on the same inputs, one sub chunk at m=1,089 (fused,
   near the envelope's edge; also bitwise) and one at m=2,500 (outside it,
   one sub-block at a time) to 1e-5;
   K6 on SPD batches at m = 900, 1,000 and
   130 for Bd = 1 and 4 and on a (2, 2, 900, 900) batch, against its plain
   version and torch.linalg.cholesky to atol 2e-5, rtol 1e-4, bitwise the
   same on a second call, strict upper triangle exactly 0, its failure flag
   clear.
   K4 and K6 report their device span per call as `ms` (device_span_ms:
   first CUDA activity to last, with the call queued behind a spin kernel),
   the time of a call whose kernels overlap by programmatic dependent
   launch. K6 is timed with that launch off too, beside the spans of
   torch.linalg.cholesky and torch.linalg.cholesky_ex. K6's times are of
   blocked_cholesky_ex, the entry with the failure flag.
5. The training path through the port's OnlineSKIRegression at bench.py's
   full-update configuration (bench.py:255-300): LinearStem(2, 2), 30x30
   grid, RBF, one output, learned second noise, slim state, lr 1e-2, 256
   seed points; depth cut to a 5-epoch fit, 64 update() calls at q = 1
   and 8 at q = 32, then one hyper_step, predict and prequential of 1,024
   points and absorb of 4,096. The launch counters are zeroed just before
   and read just after: K6 must factor Q on every update() and the
   hyper_step, K2 launch once per q = 1 update, K1 and K3 launch (on
   clusters). A CPU twin (convert) runs the first 8 updates from the same
   params and state: params within 1e-3, roots within 1e-3 * scale. Every
   loss, mll_value() and the predictions finite. Then K6's flag on the
   card (Q with one eigenvalue set to -1: NaN from spd_cholesky where
   cholesky_ex fails, the SPD Q beside it as alone to 1e-6), the hyper
   step's gradient at float32 (the closed form against autograd through
   torch.linalg.cholesky to 1e-2 of each leaf's largest entry, both beside
   a float64 reference) with the device time of its forward and of each
   backward, fit(num_epochs=1) timed 7 times after a warm-up, and a
   torch.profiler breakdown of 4 update() calls (device idle share, kernels
   by device time, host ops by self CPU time). update() rates are medians
   and spreads over the calls after the first.

6. The large-grid regime at m = 4,096 (a 64x64 grid, bench.py:474-640):
   - K1 (one chunk of k = 128), K2 (16 calls), K3 (one chunk) and K6 (Q of
     a state of the model) against their plain versions on the card, K1 and
     K3 on their single-block recursion kernels (checked by their
     counters), at phase 2's tolerances (K1 and K2 1e-5, K3 2e-4; K6 5e-4
     relative, as phase 4's Q), with device times, bounds and library
     yardsticks as in phases 2 and 4.
   - The iterative hyper step at bench_iterative_hyper_step's
     configuration: RBF, learned second noise, 1,024 seed points,
     max_cholesky_size 2,048, use_toeplitz. Gate first: the CG/SLQ MLL
     against the dense one (max_cholesky_size 2m, Q on K6) to rel 5e-2, the
     loss finite. Then 10 Adam steps, repeated: hyper steps/s (median and
     spread), the peak device memory, and one step under torch.profiler
     (launches, device idle share).
   - The rank-capped stream at bench_lowrank_stream's configuration (rank
     512, 256 seed points, 64 chunks of 256 with compressions firing).
     Gate first: in the exact regime the posterior mean matches a dense SKI
     oracle (float64) to 3e-3 * max(scale, 1). Then points/s (median and
     spread).
   - The wrappers through their entry points, with the launch counters
     zeroed just before and read just after: OnlineSKIRegression
     (LinearStem(2, 2), grid_size=64: dense, iterative GP step by default):
     16 update()s at q = 1, predict of 1,024, prequential of 512, absorb of
     1,024 (K2, K6, K3 and K1, the latter two on single blocks); the same
     with low_rank=512, and grid_size=128 (m = 16,384, routed to the
     rank-capped core): 16 updates and a predict each. Each has a CPU twin
     (the dense one runs the first update, the others the first 2): params
     within 1e-3, predictions within 1e-3 * scale. ms a call and kernel
     launches a call.

7. Dirichlet classification through the port's OnlineSKIClassifier:
   (a) the experiment layer's wiski_gpd model (IdentityStem(2), grid 16,
   m = 256, 2 classes, alpha_eps 0.01, lr 0.05) on banana_dataset(n=1200,
   seed=0): a 30-epoch fit on 100 points, set_lr(0.01), 400 streamed
   predict-then-update() calls at q = 1 (gates, the reference's: cumulative
   accuracy >= 0.70, test accuracy >= 0.75), then an absorb of the rest of
   the training split; (b) LinearStem(2, 2), grid 30 (m = 900), 2 classes,
   256 seed points: 64 update()s at q = 1, 8 at q = 32, a predict of
   1,024 and an absorb of 4,096, with a CPU twin over the first 8 updates
   (params within 1e-3, roots within 1e-3 * scale). In both the counters
   are zeroed just before and read just after: K2 once per q = 1 update,
   K6 on every update, K1 in absorb on its cluster recursion at Bd = 2.
   (c) the rank-capped classifier at grid 72 (m = 5,184, routed) with
   low_rank=256: a 30-epoch fit on 200 points, 30 updates at q = 4, test
   accuracy >= 0.8. (d) wiski_fantasize (F = 3, q = 2) and the
   differentiable route (detach_interp=False: condition at q = 1 and 2,
   stream and prequential of 16) with gradients with respect to x on (b)'s
   CUDA state, against CPU twins (values within 1e-3 * scale, gradients
   within 1e-2 of their largest entry); K1, K2 and K3 must not launch and
   the base state must come back bitwise. (e) K2, K1 and K6 at Bd = 2 on
   the states of (a) and (b) (m = 256 and 900) against their plain
   versions at phase 2's and phase 4's tolerances, with device times,
   bounds and yardsticks. update() ms, predict ms and absorb points/s are
   printed (medians and spreads).

8. The online baselines at the widths of the experiment presets
   (online_gp_tpu/experiments/config.py:24-50), each with an IdentityStem
   on CUDA tensors: exact_gp_regression, svgp_regression (256 inducing
   points, closed_form, streaming, betas 1e-3), sgpr_regression (256
   inducing points, jitter 1e-4), localgp_regression (64 experts x 256
   points) on streaming_friedman(n=4000, num_dims=5); exact_gpd and
   svgp_classification (256 inducing points) on banana_dataset(n=1200).
   Each starts on the first 5% of its training stream, fits 20 epochs,
   then runs 128 prequential steps at batch 1 (evaluate the point, then
   update()) and the test set. Gates: every loss and prediction finite;
   a CPU twin (convert) runs 8 stream steps from the state after the
   first update: params within 1e-3 of max(scale, 1), predictions within
   1e-3 of their scale (where one is missed, a float64 CPU twin runs the
   same steps, and twice the CPU's own float32-to-float64 distance is
   added to the bound), labels the same but near p = 0.5; and the JAX package's quality bars
   (tests/regression/test_baseline_models.py:33-138) at their own
   configurations. Printed: update() ms (median, spread over the calls
   after the first), predict ms of the test set, fit ms, test RMSE and NLL
   or accuracy, and one update() under torch.profiler (CUDA kernel ms and
   launches, the device's idle share, scalar readbacks and device-to-host
   copies). The baselines run no kernel of the port (the JAX ones reach
   no pl.pallas_call): the launch counters must stay at 0.

It prints the kernels as one JSON line (``launches``: the sum over the
path windows of phases 3, 4, 5, 6 and 7, phase 8 launching none; rows ``...@m4096``: phase 6's
kernel checks, with phase 6's launches; rows ``...@cls-m256-bd2`` and
``...@cls-m900-bd2``: phase 7's kernel checks, with the launches of the
windows of (a) and (b)), then the card's name and power
limit, and last {"ok": true, "device": {...}}. It needs a CUDA device
and exits non-zero without one.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from online_gp_torch import DEFAULT_CONFIG, convert
from online_gp_torch.api import (
    IdentityStem,
    LinearStem,
    OnlineExactClassifier,
    OnlineExactRegression,
    OnlineLocalGPRegression,
    OnlineSGPRegression,
    OnlineSKIClassifier,
    OnlineSKILowRankClassifier,
    OnlineSKILowRankRegression,
    OnlineSKIRegression,
    OnlineSVGPClassifier,
    OnlineSVGPRegression,
)
from online_gp_torch.data import banana_dataset, streaming_friedman
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.kernels.grid_kernel import grid_kuu_dense
from online_gp_torch.models.wiski import (
    WiskiModel,
    wiski_check_decomposition,
    wiski_condition,
    wiski_fantasize,
    wiski_init,
    wiski_mll,
    wiski_predict,
    wiski_prediction_caches,
    wiski_prequential_stream,
    wiski_slim,
    wiski_stream,
)
from online_gp_torch.models.wiski_lowrank import (
    WiskiLowRankModel,
    wiski_lowrank_condition,
    wiski_lowrank_init,
    wiski_lowrank_predict,
)
from online_gp_torch.ops import _build, cuda_chol, cuda_root_update
from online_gp_torch.ops.cuda_chol import blocked_cholesky, blocked_cholesky_ex, blocked_cholesky_plain
from online_gp_torch.ops.cuda_pred_stream import (
    pred_chunk,
    pred_chunk_stencil_plain,
    pred_cluster_plan,
)
from online_gp_torch.ops.cuda_root_update import (
    blocked_chunk,
    blocked_chunk_plain,
    chunk_cluster_plan,
    fused_root_cache_update,
    rank1_apply,
    rank1_apply_plain,
    rank1_update,
    rank1_update_plain,
)
from online_gp_torch.ops.chol import spd_cholesky
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import dense_w, interp_coeffs
from online_gp_torch.ops.precision import assert_true_f32, f32_matmul_precision
from online_gp_torch.ops.pred_stream import pred_chunk_factors
from online_gp_torch.ops.root_update import (
    RootCache,
    blocked_factors,
    blocked_factors_coord,
    blocked_factors_sub,
    root_cache_update,
    stencil_rows,
)

SEED = 0
M_SIDE = 30  # bench.py: 30x30 grid, m = 900
K = 128  # chunk rank of wiski_stream and the prequential stream
N_SEED, N_STREAM, N_COND, N_TEST, N_PREQ = 256, 16384, 256, 1024, 4096
TIMING_REPS = 20
# a host-bound metric (a loop of small launches, a host clock around
# synchronised work) is taken HOST_REPEATS times after one warm-up, and its
# median and min-max spread are printed: one run of it spread wider than
# any gap between two versions
HOST_REPEATS = 7
# a profile window opens this long before its first launch: without it,
# torch.profiler on an H100 lost the records of a window's first launches
# in up to 2% of windows (profiler_records.py)
PROFILE_PAD_S = 0.05
PROFILE_ATTEMPTS = 3
PROFILE_EXTRA_CALLS = 5  # device_ms, device_span_ms: calls a window runs before those it counts
# device_span_ms: the spin queued before each call it times (~1 ms on an
# H100), and the idle gap that splits one call from the next
SPIN_CYCLES = 2_000_000
SPAN_SPLIT_US = 250.0
N_K4 = 256  # phase 4: dense-v updates per K4 state
SUB = 32  # phase 4: K5's sub-block size
VARIANTS = {"blocked_chunk_sub": dict(sub=SUB), "blocked_chunk_coord": dict(mode="coord")}
CHOL_BLOCK = 128
CHOL_SIZES = (900, 1000, 130)  # phase 4: K6 at m = 900 (4-column last panel), 1,000, 130
CHOL_BATCHES = (1, 4)
OUTSIDE_SIDE = 50  # phase 2: a K1 chunk at m = 2,500, outside the cluster envelope
SUB_EDGE_SIDE = 33  # phase 4: a K5-sub chunk at m = 1,089, near the envelope's edge
OUTSIDE_K3 = 512  # phase 2: a K3 chunk of k = 512 at m = 900, outside it
ROWS_OUTSIDE_REGS_M = 1100  # phase 4: K4 where its row kernel cannot hold a row in registers
# phase 5: bench.py's full-update arms (bench.py:255-300) through the wrapper,
# depth cut to 5 fit epochs and 64 + 8 updates
TRAIN_LR = 1e-2
FIT_EPOCHS = 5
N_UPD1, N_UPD32, N_TWIN, N_ABSORB = 64, 8, 8, 4096
TWIN_PARAM_TOL = 1e-3  # a tenth of one Adam step at TRAIN_LR
HYPER_GRAD_RTOL = 1e-2  # float32 gradients of an O(n) objective, against the leaf's largest entry
LOG_2PI = 1.8378770664093453
# phase 6: bench.py's m = 4,096 arms (bench.py:474-640) and the wrappers at
# that width
M6_SIDE = 64  # a 64x64 grid, m = 4,096
N_SEED6 = 1024  # bench_iterative_hyper_step's seed points
N_K2_6 = 16  # K2 calls checked at m = 4,096
PLAIN_REPS6 = 3  # timing repeats of the plain versions at m = 4,096
HYPER_LR, HYPER_STEPS, HYPER_REPEATS = 1e-2, 10, 3
ITER_GATE_REL = 5e-2  # bench.py:611
LR_RANK, LR_SEED, LR_CHUNK, LR_CHUNKS, LR_REPEATS = 512, 256, 256, 64, 3
LR_GATE = 3e-3  # bench.py:536, times max(scale, 1)
N_WRAP_SEED, N_WRAP_UPD, N_PREQ6, N_ABSORB6 = 256, 16, 512, 1024
BIG_SIDE = 128  # m = 16,384: above DENSE_GRID_LIMIT, routed to the rank-capped core
# phase 7: Dirichlet classification through OnlineSKIClassifier
CLS_ALPHA_EPS = 0.01
# (a) the experiment layer's wiski_gpd model (online_gp_tpu/experiments/config.py:45-46), as
# tests/classification/test_ski_classifier.py::test_online_eye_stem runs it, with its gates (:94-95)
GPD_N, GPD_SIDE, GPD_LR, GPD_INIT, GPD_EPOCHS, GPD_STREAM_LR, GPD_STREAM = 1200, 16, 0.05, 100, 30, 0.01, 400
GPD_CUM_GATE, GPD_TEST_GATE = 0.70, 0.75
# (b) the dense classifier's default width (grid 30, m = 900): banana points, depth cut
CLS_N, CLS_SEED_PTS, CLS_UPD1, CLS_UPD32, CLS_TWIN, CLS_PRED, CLS_ABSORB = 8000, 256, 64, 8, 8, 1024, 4096
# (c) tests/classification/test_lowrank_classifier.py:22-35, with its gate
LRC_SIDE, LRC_RANK, LRC_INIT, LRC_EPOCHS, LRC_UPDATES, LRC_GATE = 72, 256, 200, 30, 30, 0.8
N_FANT, Q_FANT = 3, 2  # (d) fantasies and points per fantasy
# phase 8: the online baselines at the experiment presets' widths
# (online_gp_tpu/experiments/config.py:24-50; num_update_steps = batch size 1), IdentityStem
BASE_N, BASE_DIMS, BASE_CLS_N = 4000, 5, 1200  # streaming_friedman (3,600 / 400), banana_dataset (960 / 240)
# the stream cut from 256 to 128 steps to keep phase 8 near a minute (77 s at 256 on a slow host)
BASE_INIT_RATIO, BASE_FIT_EPOCHS, BASE_STREAM, BASE_TWIN = 0.05, 20, 128, 8
BASE_TWIN_RTOL = 1e-3  # params against max(scale, 1), predictions against their scale
BASE_PRESETS = {
    "exact_gp_regression": (OnlineExactRegression, "regression", dict(lr=1e-2)),
    "svgp_regression": (OnlineSVGPRegression, "regression", dict(
        num_inducing=256, lr=1e-2, streaming=True, prior_beta=1e-3, online_beta=1e-3, num_update_steps=1,
        variational_mode="closed_form")),
    "sgpr_regression": (OnlineSGPRegression, "regression", dict(
        num_inducing=256, lr=1e-2, num_update_steps=1, jitter=1e-4)),
    "localgp_regression": (OnlineLocalGPRegression, "regression", dict(
        lr=1e-2, max_data_per_model=256, max_experts=64)),
    "exact_gpd": (OnlineExactClassifier, "classification", dict(alpha_eps=0.01, lr=1e-2)),
    "svgp_classification": (OnlineSVGPClassifier, "classification", dict(
        num_inducing=256, lr=1e-2, prior_beta=1e-3, online_beta=1e-3, num_update_steps=1)),
}

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


def rank1_bound(Bd, m, peaks):
    """K2: L and B read and written, p read; two matvecs and two outer products."""
    return bound_ms(4 * (4 * Bd * m * m + Bd * m), Bd * (8 * m * m + 4 * m), peaks)


def chunk_bound(Bd, m, k, P, peaks):
    """K1: L and B read and written, the stencil read; the gather, the
    recursion (10 t m flops at step t) and the two rank-k applies."""
    return bound_ms(4 * (4 * Bd * m * m + Bd * k * P + k * P),
                    Bd * (2 * k * P * m + 5 * k * (k - 1) * m + 8 * m * m * k), peaks)


def pred_bound(Bd, m, k, P, peaks):
    """K3: C is symmetric, so C -= Z^T Z needs only its m (m + 1) / 2
    distinct entries read and written, at 2 k flops each (a SYRK)."""
    nbytes = 4 * (Bd * m * (m + 1) + 2 * Bd * m + 4 * Bd * k) + 8 * k * P
    return bound_ms(nbytes, Bd * (2 * k * P * m + k * (k - 1) * m + m * (m + 1) * k + 2 * m * k), peaks)


def chol_bound(Bd, m, peaks):
    """K6: Q read, L written; m^3 / 3 flops a matrix."""
    return bound_ms(4 * 2 * Bd * m * m, Bd * m**3 / 3, peaks)


def rank1_library(L, B, p):
    """K2's yardstick: torch.mv and Tensor.addr_ per output."""
    s2 = torch.sum(p * p, dim=-1)
    s = torch.sqrt(s2)
    u = p / torch.clamp(s, min=1e-20)[:, None]
    c, d = torch.sqrt(s2 + 1) - 1, 1 / torch.sqrt(s2 + 1) - 1
    for b in range(L.shape[0]):
        L[b].addr_(torch.mv(L[b], u[b]) * c[b], u[b])
        B[b].addr_(torch.mv(B[b], u[b]) * d[b], u[b])


def chunk_library(U, Pm, R):
    """K1's yardstick: a chunk's applies, from the plain recursion's U, P, R,
    as baddbmm."""
    def library(L, B):
        L.baddbmm_(torch.bmm(L, R.mT), U)
        B.baddbmm_(torch.bmm(B, Pm.mT), U)

    return library


def pred_library(Zf, rf):
    """K3's yardstick: a chunk's applies, from the plain recursion's Z and r."""
    def library(C, mu):
        C.baddbmm_(Zf.mT, Zf, alpha=-1.0)
        mu.add_(torch.bmm(Zf.mT, rf[..., None])[..., 0])

    return library


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


def profile_window(fn, make_args, kernels, reps, pad_s=PROFILE_PAD_S):
    """One torch.profiler window over reps calls of fn(*make_args()),
    opened pad_s seconds before the first launch. Returns the profiler and
    {kernel: (records, device us)} for the named kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            fn(*make_args())
        torch.cuda.synchronize()
    records = dict.fromkeys(kernels, (0, 0.0))
    for ev in prof.key_averages():
        for kname in kernels:
            if f"::{kname}(" in ev.key:
                records[kname] = (ev.count, ev.self_device_time_total)
    return prof, records


def device_ms(fn, make_args, kernels, reps=TIMING_REPS):
    """Mean device time per call of fn(*make_args()), summed over the named
    CUDA kernels from torch.profiler, and each kernel's share. The inputs
    are made fresh before each call, as in time_ms; the copies that makes
    are other kernels and are not counted. ``kernels`` maps each CUDA
    kernel's name to its launches per call. Each window runs
    PROFILE_EXTRA_CALLS calls more than it counts, first, and the time is
    the mean over each kernel's last reps x launches records: torch.profiler
    may lose the records of a window's first launches even after the pad
    (on an H100, three windows in a row lost the first 3 of K2's 20 at
    m = 256).
    A window that kept fewer is printed and profiled again, up to
    PROFILE_ATTEMPTS windows, and then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*make_args())
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps + PROFILE_EXTRA_CALLS):
                fn(*make_args())
            torch.cuda.synchronize()
        records = {k: sorted((e.time_range.start, e.time_range.end - e.time_range.start) for e in prof.events()
                             if e.device_type == DeviceType.CUDA and f"::{k}(" in e.name) for k in kernels}
        short = {k: len(v) for k, v in records.items() if len(v) < reps * kernels[k]}
        if not short:
            per_kernel = {k: sum(d for _, d in v[-reps * kernels[k]:]) / reps / 1e3 for k, v in records.items()}
            return sum(per_kernel.values()), per_kernel
        want = {k: reps * kernels[k] for k in short}
        print(f"  torch.profiler recorded {short} launches of at least {want}; profiling again")
    raise AssertionError(f"no profile of {PROFILE_ATTEMPTS} recorded every launch of {sorted(kernels)}")


def device_span_ms(fn, make_args, kernels=None, reps=TIMING_REPS):
    """(mean device span, {kernel: mean summed duration}) per call of
    fn(*make_args()). The span runs from the start of the call's first
    CUDA activity to the end of its last (torch.profiler). A spin kernel
    (torch.cuda._sleep, SPIN_CYCLES) runs on the stream just before each
    call, so every launch of the call is queued before the device reaches
    it: the span is the device's time for the call, not the host's time to
    issue it. For kernels launched with programmatic dependent launch this
    is the call's device time; their summed durations also count the time
    a kernel sat scheduled, waiting on the one before. ``kernels`` maps the CUDA kernels to count
    to their launches per call (the copies make_args makes are other
    kernels); None counts every CUDA activity of the window but the spin,
    and then make_args must launch nothing. Each window runs
    PROFILE_EXTRA_CALLS calls more than it counts, first, and keeps the
    last reps: torch.profiler may lose the records of a window's first
    launches even after the pad (on an H100, three windows in a row lost
    one of K6's 23 records at m = 900; others lost two whole calls of K6
    at m = 256). A window
    whose kept calls were not each recorded whole is printed and profiled
    again, up to PROFILE_ATTEMPTS windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*make_args())
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps + PROFILE_EXTRA_CALLS):
                args = make_args()
                torch.cuda.synchronize()
                torch.cuda._sleep(SPIN_CYCLES)
                fn(*args)
                torch.cuda.synchronize()
        events = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
            and (kernels is None or any(f"::{k}(" in e.name for k in kernels)))
        calls = []  # [start, end, activities] per call, split where a spin stood between
        for start, end, _ in events:
            if calls and start - calls[-1][1] < SPAN_SPLIT_US:
                calls[-1][1] = max(calls[-1][1], end)
                calls[-1][2] += 1
            else:
                calls.append([start, end, 1])
        kept = calls[-reps:]  # the window's first calls are dropped (or lost in part)
        if kernels is None:  # no count per call to check: no call may have split
            whole = len(calls) <= reps + PROFILE_EXTRA_CALLS
        else:
            whole = all(n == sum(kernels.values()) for _, _, n in kept)
        if len(calls) >= reps and whole:
            stages = {k: sum(end - start for start, end, name in events
                             if start >= kept[0][0] and f"::{k}(" in name) / reps / 1e3
                      for k in kernels or {}}
            return sum(end - start for start, end, _ in kept) / reps / 1e3, stages
        print(f"  torch.profiler recorded {len(calls)} calls of {reps} + {PROFILE_EXTRA_CALLS} "
              f"(activities per call {[n for _, _, n in calls]}); profiling again")
    raise AssertionError(f"no profile of {PROFILE_ATTEMPTS} recorded every call of {fn}")


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


# the launch counters of the main-path kernels (K2, K1, K3, K6), zeroed just
# before a path window and read just after
COUNTED = [(rank1_apply, "launches"), (blocked_chunk, "launches"), (blocked_chunk, "cluster_launches"),
           (pred_chunk, "launches"), (pred_chunk, "cluster_launches"), (blocked_cholesky, "launches")]


def zero_counters():
    for wrapper, attr in COUNTED:
        setattr(wrapper, attr, 0)


def read_counters():
    return {"rank1_apply": rank1_apply.launches, "blocked_chunk": blocked_chunk.launches,
            "chunk_recursion_cluster": blocked_chunk.cluster_launches, "pred_chunk": pred_chunk.launches,
            "pred_recursion_cluster": pred_chunk.cluster_launches, "blocked_cholesky": blocked_cholesky.launches}


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

        make = lambda: (*clone_all(L, B), p)
        bms, by = rank1_bound(Bd, m, peaks)
        ms, stages = device_ms(rank1_apply, make, {"rank1_prepass_kernel": 1, "rank1_rows_kernel": 1})
        out[Bd] = dict(
            max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(rank1_apply, make),
            plain_ms=time_ms(rank1_apply_plain, make), library_ms=time_ms(rank1_library, make),
            bound_ms=bms, bound_by=by,
        )
    return out


def plain_stream(L, B, idx, wv, k, **kw):
    for c in range(idx.shape[0] // k):
        L, B = blocked_chunk_plain(L, B, idx[c * k : (c + 1) * k], wv[:, c * k : (c + 1) * k], **kw)
    return L, B


def check_blocked_chunk(rng, grid, peaks, dev):
    """K1 against its plain version; returns the chunk's results and its
    cluster recursion's (chunk_recursion_cluster_kernel within the chunk)."""
    m = grid.num_points
    plan = chunk_cluster_plan(K, m)
    out, rec = {}, {}
    for Bd in (1, 2):
        L, B = synthetic_roots(rng, Bd, m, dev)
        _, idx, w = stencil(rng, grid, 4 * K, dev)
        wv = (w[None] * torch.tensor([1.0, 1.3][:Bd], device=dev)[:, None, None]).contiguous()
        i1, wv1 = idx[:K].contiguous(), wv[:, :K].contiguous()
        want = blocked_chunk_plain(L, B, i1, wv1)
        got = blocked_chunk(*clone_all(L, B), i1, wv1)
        again = blocked_chunk(*clone_all(L, B), i1, wv1)
        torch.cuda.synchronize()
        err = max_err(got, want, 1e-5, f"blocked_chunk Bd={Bd}")
        bitwise(got, again, f"blocked_chunk Bd={Bd}")
        want_s = plain_stream(L, B, idx, wv, K)
        Lk, Bk = clone_all(L, B)
        for c in range(4):
            Lk, Bk = blocked_chunk(Lk, Bk, idx[c * K : (c + 1) * K].contiguous(), wv[:, c * K : (c + 1) * K].contiguous())
        torch.cuda.synchronize()
        err_stream = max_err((Lk, Bk), want_s, 2e-4, f"blocked_chunk 4-chunk stream Bd={Bd}")

        # the yardstick applies this chunk's U, P, R from the plain recursion
        p0 = torch.einsum("bkp,bkpm->bkm", wv1, B[:, i1.long()])
        library = chunk_library(*blocked_factors(p0))
        make = lambda: (*clone_all(L, B), i1, wv1)
        bms, by = chunk_bound(Bd, m, K, idx.shape[1], peaks)
        ms, stages = device_ms(blocked_chunk, make, {
            "chunk_gather_kernel": 1, "chunk_recursion_cluster_kernel": 1, "chunk_apply_t_kernel": 1,
            "chunk_apply_x_kernel": 1})
        out[Bd] = dict(
            max_abs_err=err, stream_max_abs_err=err_stream, ms=ms, stages_ms=stages,
            wrapper_ms=time_ms(blocked_chunk, make), plain_ms=time_ms(blocked_chunk_plain, make),
            library_ms=time_ms(library, lambda: clone_all(L, B)), bound_ms=bms, bound_by=by,
        )
        # a, p, U p, P^T g, R^T g: 10 t m flops at step t; p0 in, U, P, R out
        bms, by = bound_ms(4 * 4 * Bd * K * m, Bd * 5 * K * (K - 1) * m, peaks)
        rec[Bd] = dict(
            max_abs_err=err, ms=stages["chunk_recursion_cluster_kernel"], cluster=plan.cluster,
            shared_bytes=plan.shared_bytes, plain_ms=time_ms(blocked_factors, lambda: (p0,)),
            library_ms=None, bound_ms=bms, bound_by=by,
        )
    out["outside"] = check_chunk_outside_envelope(rng, dev)
    return out, rec


def check_chunk_outside_envelope(rng, dev):
    """One K1 chunk at a shape no cluster holds (OUTSIDE_SIDE^2 grid, k = K):
    it runs the single-block recursion kernel, against the plain version."""
    grid = Grid.create([(-1.1, 1.1)] * 2, OUTSIDE_SIDE, device=dev)
    m = grid.num_points
    if chunk_cluster_plan(K, m) is not None:
        raise AssertionError(f"(k={K}, m={m}) was meant to lie outside the cluster envelope")
    L, B = synthetic_roots(rng, 1, m, dev)
    _, idx, w = stencil(rng, grid, K, dev)
    wv = w[None].contiguous()
    before = (blocked_chunk.launches, blocked_chunk.cluster_launches)
    got = blocked_chunk(*clone_all(L, B), idx, wv)
    torch.cuda.synchronize()
    if (blocked_chunk.launches - before[0], blocked_chunk.cluster_launches - before[1]) != (1, 0):
        raise AssertionError(f"blocked_chunk at m={m} did not take the single-block recursion")
    err = max_err(got, blocked_chunk_plain(L, B, idx, wv), 1e-5, f"blocked_chunk m={m}")
    make = lambda: (*clone_all(L, B), idx, wv)
    ms, stages = device_ms(blocked_chunk, make, {
        "chunk_gather_kernel": 1, "chunk_recursion_kernel": 1, "chunk_apply_t_kernel": 1, "chunk_apply_x_kernel": 1})
    return dict(m=m, k=K, max_abs_err=err, ms=ms, stages_ms=stages)


def bitwise(got, again, what):
    """Raise unless two calls on the same inputs gave identical outputs."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")


def check_pred_chunk(rng, grid, model, params, peaks, dev):
    """K3 against its plain version; returns the chunk's results and its
    cluster recursion's (pred_recursion_cluster_kernel within the chunk)."""
    m = grid.num_points
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), dtype=torch.float32, device=dev)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_init(model, x0, y0, torch.ones_like(y0))
    mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    out, rec = {}, {}
    for Bd in (1, 2):
        C = torch.cat([cov_cache, 0.9 * cov_cache])[:Bd].contiguous()
        mu = torch.cat([mean_cache[..., 0], -mean_cache[..., 0]])[:Bd].contiguous()
        x, idx, w = stencil(rng, grid, K, dev)
        y = (torch.sin(3 * x[:, 0])[None] * torch.tensor([1.0, 0.5][:Bd], device=dev)[:, None]).contiguous()
        nz = torch.ones((Bd, K), device=dev)
        want = pred_chunk_stencil_plain(C, mu, idx, w, y, nz)
        got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
        again = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
        torch.cuda.synchronize()
        err = max_err(got, want, 2e-4, f"pred_chunk Bd={Bd}")
        bitwise(got, again, f"pred_chunk Bd={Bd}")

        # the yardstick applies this chunk's Z and r from the plain recursion
        S = stencil_rows(idx, w, m)
        plain_args = (S, S @ C, mu @ S.mT, y, nz)
        library = pred_library(*pred_chunk_factors(*plain_args)[:2])
        make = lambda: (*clone_all(C, mu), idx, w, y, nz)
        P = idx.shape[1]
        bms, by = pred_bound(Bd, m, K, P, peaks)
        ms, stages = device_ms(pred_chunk, make, {"pred_gather_kernel": 1, "pred_recursion_cluster_kernel": 1,
                                                          "pred_apply_kernel": 1})
        out[Bd] = dict(
            max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(pred_chunk, make),
            plain_ms=time_ms(pred_chunk_stencil_plain, make),
            library_ms=time_ms(library, lambda: clone_all(C, mu)), bound_ms=bms, bound_by=by,
        )
        # a: 2 t P, ct: 2 t m flops at step t; c0w in, Z out
        bms, by = bound_ms(4 * (2 * Bd * K * m + 5 * Bd * K) + 8 * K * P, Bd * K * (K - 1) * (m + P), peaks)
        plan = pred_cluster_plan(K, m, P)
        rec[Bd] = dict(
            max_abs_err=err, ms=stages["pred_recursion_cluster_kernel"], cluster=plan.cluster,
            shared_bytes=plan.shared_bytes, plain_ms=time_ms(pred_chunk_factors, lambda: plain_args),
            library_ms=None, bound_ms=bms, bound_by=by,
        )
    out["outside"] = check_pred_chunk_outside_envelope(rng, grid, cov_cache, mean_cache[..., 0], dev)
    return out, rec


def check_pred_chunk_outside_envelope(rng, grid, C, mu, dev):
    """One K3 chunk at a shape no cluster holds (k = OUTSIDE_K3 at the main
    path's m): it runs the single-block recursion kernel, against the plain
    version."""
    m = grid.num_points
    x, idx, w = stencil(rng, grid, OUTSIDE_K3, dev)
    if pred_cluster_plan(OUTSIDE_K3, m, idx.shape[1]) is not None:
        raise AssertionError(f"(k={OUTSIDE_K3}, m={m}) was meant to lie outside the cluster envelope")
    C, mu = C.contiguous(), mu.contiguous()
    y = torch.sin(3 * x[:, 0])[None].contiguous()
    nz = torch.ones((1, OUTSIDE_K3), device=dev)
    before = (pred_chunk.launches, pred_chunk.cluster_launches)
    got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
    torch.cuda.synchronize()
    if (pred_chunk.launches - before[0], pred_chunk.cluster_launches - before[1]) != (1, 0):
        raise AssertionError(f"pred_chunk at k={OUTSIDE_K3} did not take the single-block recursion")
    err = max_err(got, pred_chunk_stencil_plain(C, mu, idx, w, y, nz), 2e-4, f"pred_chunk k={OUTSIDE_K3}")
    make = lambda: (*clone_all(C, mu), idx, w, y, nz)
    ms, stages = device_ms(pred_chunk, make, {
        "pred_gather_kernel": 1, "pred_recursion_kernel": 1, "pred_apply_kernel": 1})
    return dict(m=m, k=OUTSIDE_K3, max_abs_err=err, ms=ms, stages_ms=stages)


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
    xc, yc, nc = points(N_COND * (1 + HOST_REPEATS))
    xt, _, _ = points(N_TEST)
    xp, yp, npr = points(N_PREQ)
    gate_roots = RootCache(None, state.roots.root.clone(), state.roots.inv_root.clone())
    torch.cuda.synchronize()

    wrappers = (rank1_apply, blocked_chunk, pred_chunk, blocked_cholesky)  # K6: Q of the prediction caches
    for wrapper in wrappers:
        wrapper.launches = 0
    blocked_chunk.cluster_launches = pred_chunk.cluster_launches = 0
    t0 = time.perf_counter()
    state = wiski_stream(model, state, xs, ys, ns, block_size=K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cond_s = []  # the 256-call loop, one warm-up and HOST_REPEATS timed
    for rep in range(1 + HOST_REPEATS):
        r0 = time.perf_counter()
        for i in range(rep * N_COND, (rep + 1) * N_COND):
            state = wiski_condition(model, state, xc[i : i + 1], yc[i : i + 1], nc[i : i + 1])
        torch.cuda.synchronize()
        cond_s.append(time.perf_counter() - r0)
    pred_s = []  # caches + predict, the same
    for _ in range(1 + HOST_REPEATS):
        r0 = time.perf_counter()
        caches = wiski_prediction_caches(model, params, state)
        mean, var = wiski_predict(model, params, state, xt, caches=caches)
        torch.cuda.synchronize()
        pred_s.append(time.perf_counter() - r0)
    t3 = time.perf_counter()
    state, caches, pm, pv = wiski_prequential_stream(model, params, state, caches, xp, yp, npr, block_size=K)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {w.__name__: w.launches for w in wrappers}
    launches["chunk_recursion_cluster"] = blocked_chunk.cluster_launches
    launches["pred_recursion_cluster"] = pred_chunk.cluster_launches

    print(f"main path on {card}:")
    print(f"  wiski_stream {N_STREAM} points, block {K}: {N_STREAM / (t1 - t0):.1f} updates/s ({t1 - t0:.4f} s)")
    rates = [N_COND / t for t in cond_s[1:]]
    print(f"  wiski_condition x{N_COND}, {HOST_REPEATS} repeats after a warm-up: median "
          f"{np.median(rates):.1f} updates/s, spread {min(rates):.1f}-{max(rates):.1f}")
    print(f"  prediction caches + predict {N_TEST} points, {HOST_REPEATS} repeats after a warm-up: median "
          f"{np.median(pred_s[1:]):.5f} s, spread {min(pred_s[1:]):.5f}-{max(pred_s[1:]):.5f}")
    print(f"  wiski_prequential_stream {N_PREQ} points: {N_PREQ / (t4 - t3):.1f} points/s ({t4 - t3:.4f} s)")
    print(f"  kernel launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if (launches["chunk_recursion_cluster"], launches["pred_recursion_cluster"]) != (
            launches["blocked_chunk"], launches["pred_chunk"]):
        raise AssertionError("a chunk of the main path at m = 900 did not run its recursion on a cluster")

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
    profile_main_path(model, params, state, caches, (xs, ys, ns), (xp, yp, npr))
    return launches, state


def profile_main_path(model, params, state, caches, stream, preq, n=2 * K):
    """The CUDA kernels torch.profiler records over a short pass of the
    main path's streams (n points of each) on copies of its final state:
    the cluster recursions run, and the single-block ones do not."""
    from torch.profiler import ProfilerActivity, profile

    copy = lambda st: st._replace(roots=RootCache(None, st.roots.root.clone(), st.roots.inv_root.clone()))
    caches = tuple(c.clone() for c in caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        wiski_stream(model, copy(state), *(a[:n] for a in stream), block_size=K)
        wiski_prequential_stream(model, params, copy(state), caches, *(a[:n] for a in preq), block_size=K)
        torch.cuda.synchronize()
    counts = {}
    for ev in prof.key_averages():
        for name in ("chunk_recursion_cluster_kernel", "pred_recursion_cluster_kernel",
                     "chunk_recursion_kernel", "pred_recursion_kernel"):
            if f"::{name}(" in ev.key:
                counts[name] = counts.get(name, 0) + ev.count
    print(f"  recursion kernels recorded over {n} + {n} main-path points: {json.dumps(counts)}")
    if not (counts.get("chunk_recursion_cluster_kernel") and counts.get("pred_recursion_cluster_kernel")):
        raise AssertionError("torch.profiler recorded no cluster recursion on the main path")
    if counts.get("chunk_recursion_kernel") or counts.get("pred_recursion_kernel"):
        raise AssertionError("the main path at m = 900 launched a single-block recursion kernel")


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


# --------------------------------------------------------------------------
# phase 4: the remaining kernels' entry points at m = 900
# --------------------------------------------------------------------------


def dense_updates(grid, x, noise):
    """(n, Bd, m, 1) dense update vectors v = W_x/sqrt(noise), one per point,
    as plain_prefix_roots builds them; noise is (n, Bd)."""
    idx, w = interp_coeffs(grid, x, detach=True)
    W = dense_w(idx, w, grid.num_points)  # (m, n)
    v = W.T[:, None, :] / torch.sqrt(torch.clamp(noise, min=1e-7))[:, :, None]
    return v[..., None].contiguous()


def rel_max_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def q_matrix(model, params, state):
    """Q = I + L^T Kuu_hat L of a WISKI state, Kuu_hat = K_uu / s2 (the
    learned second noise, where the model has one), as the MLL and the
    prediction caches form it."""
    Kuu = grid_kuu_dense(model.kernel, params["kernel"], model.grid).detach()
    if model.learn_additional_noise:
        Kuu = Kuu / torch.exp(params["raw_second_noise"].detach())[:, None, None]
    L = state.roots.root
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return (eye + L.mT @ (Kuu @ L)).contiguous()


def remaining_path(rng, model, params, final_state, card, dev):
    """Phase 4's path: K4, K5 and K6 through their entry points on WISKI
    states at the bench width. Returns the launch counts of this path."""
    f32 = dict(dtype=torch.float32, device=dev)
    grid = model.grid
    m = grid.num_points
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), **f32)
    y0 = torch.sin(3 * x0[:, :1])
    model2 = WiskiModel(RBFKernel(), grid, num_outputs=2, learn_additional_noise=True)
    noise2 = torch.tensor([1.0, 0.5], **f32).expand(N_SEED, 2).contiguous()
    full1 = wiski_init(model, x0, y0, torch.ones_like(y0))
    full2 = wiski_init(model2, x0, y0 * torch.tensor([1.0, 0.5], **f32), noise2)
    xk = torch.tensor(rng.uniform(-1, 1, (N_K4, 2)), **f32)
    v1 = dense_updates(grid, xk, torch.ones((N_K4, 1), **f32))
    k4_cases = {
        "full Bd=1": (full1, v1),
        "full Bd=2": (full2, dense_updates(grid, xk, noise2[:1].expand(N_K4, 2))),
        "slim Bd=1": (wiski_slim(full1), v1),
    }
    x5 = torch.tensor(rng.uniform(-1, 1, (4 * K, 2)), **f32)
    idx5, w5 = interp_coeffs(grid, x5, detach=True)
    idx5 = idx5.to(torch.int32).contiguous()
    wv5 = w5[None].contiguous()  # noise 1
    Q = q_matrix(model, params, final_state)
    starts = {name: RootCache(*(None if t is None else t.clone() for t in st.roots)) for name, (st, _) in k4_cases.items()}
    k5_start = (final_state.roots.root.clone(), final_state.roots.inv_root.clone())
    torch.cuda.synchronize()

    counters = [(rank1_update, "launches"), (blocked_chunk, "sub_launches"), (blocked_chunk, "sub_cluster_launches"),
                (blocked_chunk, "coord_launches"), (blocked_cholesky, "launches")]
    for wrapper, attr in counters:
        setattr(wrapper, attr, 0)
    t0 = time.perf_counter()
    k4_out = {}
    for name, (_, vs) in k4_cases.items():
        roots = RootCache(*(None if t is None else t.clone() for t in starts[name]))
        for i in range(N_K4):
            roots = fused_root_cache_update(roots, vs[i])
        k4_out[name] = roots
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k5_out = {}
    for kname, kw in VARIANTS.items():
        Lk, Bk = (t.clone() for t in k5_start)
        for c in range(4):
            rows = slice(c * K, (c + 1) * K)
            Lk, Bk = blocked_chunk(Lk, Bk, idx5[rows].contiguous(), wv5[:, rows].contiguous(), **kw)
        k5_out[kname] = (Lk, Bk)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    Lq = blocked_cholesky(Q, CHOL_BLOCK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {
        "rank1_update": rank1_update.launches,
        "blocked_chunk_sub": blocked_chunk.sub_launches,
        "chunk_sub_cluster": blocked_chunk.sub_cluster_launches,
        "blocked_chunk_coord": blocked_chunk.coord_launches,
        "blocked_cholesky": blocked_cholesky.launches,
    }

    print(f"remaining kernels' entry points on {card}:")
    print(f"  fused_root_cache_update: 3 x {N_K4} dense-v updates in {t1 - t0:.4f} s")
    print(f"  blocked_chunk sub={SUB} and coord: 2 x 4 chunks of {K} in {t2 - t1:.4f} s")
    print(f"  blocked_cholesky of Q (m={m}, block {CHOL_BLOCK}): {t3 - t2:.4f} s")
    print(f"  kernel launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"phase 4 never launched {name}")
    if launches["chunk_sub_cluster"] != launches["blocked_chunk_sub"]:
        raise AssertionError(f"a K5-sub chunk at m = {m} did not run on the fused cluster kernel")

    for name, (st, vs) in k4_cases.items():
        oracle = starts[name]
        for i in range(N_K4):
            oracle = root_cache_update(oracle, vs[i])
        got = k4_out[name]
        scale = float(oracle.root.abs().max())
        err = float((got.root - oracle.root).abs().max())
        inv_err = float((got.inv_root - oracle.inv_root).abs().max())
        inv_scale = float(oracle.inv_root.abs().max())
        print(f"  K4 {name}: root err {err:.3e} (scale {scale:.3e}), inverse root err {inv_err:.3e} (scale {inv_scale:.3e})")
        if not (err <= 1e-3 * max(scale, 1.0) and inv_err <= 1e-3 * max(inv_scale, 1.0)):
            raise AssertionError(f"K4 {name}: roots drift from the plain update over {N_K4} updates")
        if oracle.mat is None:
            if got.mat is not None:
                raise AssertionError(f"K4 {name}: a slim cache came back with a Gram accumulator")
        else:
            print(f"  K4 {name}: A max abs err {max_err((got.mat,), (oracle.mat,), 1e-5, f'K4 {name} A'):.3e}")
        check = wiski_check_decomposition(st._replace(roots=got))
        errs = {key: float(val.max()) for key, val in check.items()}
        print(f"  K4 {name}: wiski_check_decomposition {json.dumps(errs)}")
        finite = [v for key, v in errs.items() if oracle.mat is not None or key == "inverse_root_err"]
        if not all(math.isfinite(v) for v in finite):
            raise AssertionError(f"K4 {name}: non-finite decomposition error")

    flat = plain_stream(*k5_start, idx5, wv5, K)
    for kname, kw in VARIANTS.items():
        want = plain_stream(*k5_start, idx5, wv5, K, **kw)
        err = max_err(k5_out[kname], want, 2e-4, f"{kname} 4-chunk stream on the final state")
        dist = max(float((a - b).abs().max()) for a, b in zip(k5_out[kname], flat))
        print(f"  {kname}: 4-chunk stream max abs err {err:.3e} vs plain, {dist:.3e} from the flat plain stream")

    want = blocked_cholesky_plain(Q, CHOL_BLOCK)
    lib = torch.linalg.cholesky(Q)
    e_plain, e_lib = rel_max_err(Lq, want), rel_max_err(Lq, lib)
    print(f"  K6 on Q: relative max err {e_plain:.3e} vs plain, {e_lib:.3e} vs torch.linalg.cholesky")
    if not (e_plain <= 5e-4 and e_lib <= 5e-4):
        raise AssertionError("K6 on Q exceeds the 5e-4 relative bound")
    if not bool((torch.triu(Lq, 1) == 0).all()):
        raise AssertionError("K6: the strict upper triangle is not exactly 0")
    return launches, Q


def check_rank1_update(rng, grid, peaks, dev):
    m = grid.num_points
    out = {}
    for label, Bd, slim in ((1, 1, False), (2, 2, False), ("slim Bd=1", 1, True)):
        L, B = synthetic_roots(rng, Bd, m, dev)
        A = None if slim else (L @ L.mT).contiguous()
        x = torch.tensor(rng.uniform(-1, 1, (1, 2)), dtype=torch.float32, device=dev)
        v = dense_updates(grid, x, torch.ones((1, Bd), device=dev))[0]
        if Bd == 2:
            v[1] = 0.0  # p = 0 is an exact no-op
        clone = lambda: (L.clone(), B.clone(), None if A is None else A.clone(), v)
        want = rank1_update_plain(L, B, A, v)
        got = rank1_update(*clone())
        again = rank1_update(*clone())
        torch.cuda.synchronize()
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        err = max_err([g for g, _ in pairs], [w for _, w in pairs], 1e-5, f"rank1_update {label}")
        bitwise([g for g in got if g is not None], [a for a in again if a is not None], f"rank1_update {label}")
        if Bd == 2 and not (torch.equal(got[0][1], L[1]) and torch.equal(got[1][1], B[1]) and torch.equal(got[2][1], A[1])):
            raise AssertionError("rank1_update: v = 0 changed the state")

        def library(L, B, A, v):
            for b in range(L.shape[0]):
                vb = v[b, :, 0]
                p = torch.mv(B[b].T, vb)
                s2 = torch.dot(p, p)
                u = p / torch.clamp(torch.sqrt(s2), min=1e-20)
                L[b].addr_(torch.mv(L[b], u) * (torch.sqrt(s2 + 1) - 1), u)
                B[b].addr_(torch.mv(B[b], u) * (1 / torch.sqrt(s2 + 1) - 1), u)
                if A is not None:
                    A[b].addr_(vb, vb)

        nbytes = 4 * ((4 if slim else 6) * Bd * m * m + Bd * m)
        flops = Bd * ((10 if slim else 12) * m * m + 6 * m)
        bms, by = bound_ms(nbytes, flops, peaks)
        ms, stages = device_span_ms(rank1_update, clone, {"rank1_p_kernel": 1, "rank1_rows_kernel": 1})
        out[label] = dict(
            max_abs_err=err, ms=ms, kernel_sum_ms=sum(stages.values()), stages_ms=stages,
            wrapper_ms=time_ms(rank1_update, clone),
            plain_ms=time_ms(rank1_update_plain, clone), library_ms=time_ms(library, clone),
            bound_ms=bms, bound_by=by,
        )
    # above m = 1,024 the row kernel (K4's and K2's) loops over a row
    # instead of holding it in registers
    m2 = ROWS_OUTSIDE_REGS_M
    L, B = synthetic_roots(rng, 1, m2, dev)
    A = (L @ L.mT).contiguous()
    v = torch.tensor(rng.normal(size=(1, m2, 1)), dtype=torch.float32, device=dev)
    got = rank1_update(L.clone(), B.clone(), A.clone(), v)
    torch.cuda.synchronize()
    err = max_err(got, rank1_update_plain(L, B, A, v), 1e-5, f"rank1_update m={m2}")
    out[f"rows outside registers (m={m2})"] = dict(max_abs_err=err)
    return out


def check_chunk_variants(rng, grid, peaks, dev):
    """K5 (sub=SUB and coord) against its plain version at m = 900, Bd = 1
    and 2: one chunk to 1e-5, bitwise the same on a second call, a 4-chunk
    stream to 2e-4, the distance to flat K1, and device times with K1
    flat's beside them on the same inputs (flat_ms). The profiled kernel
    counts hold the design: sub is one gather, the fused cluster kernel and
    one apply, with no correction GEMM and no per-sub-block recursion; coord
    is the gather, M, its recursion, one rebuild GEMM and one apply. Then a
    K5-sub chunk on each side of the fused kernel's envelope edge."""
    m = grid.num_points
    profile_kernels = {
        "blocked_chunk_sub": {"chunk_gather_kernel": 1, "chunk_sub_cluster_kernel": 1, "chunk_apply_t_kernel": 1,
                              "chunk_apply_x_kernel": 1, "batched_gemm_kernel": 0,
                              "chunk_recursion_cluster_kernel": 0, "chunk_recursion_kernel": 0},
        "blocked_chunk_coord": {"chunk_gather_kernel": 1, "coord_gram_kernel": 1, "coord_recursion_kernel": 1,
                                "batched_gemm_kernel": 1, "chunk_apply_t_kernel": 1, "chunk_apply_x_kernel": 1},
    }
    flat_kernels = {"chunk_gather_kernel": 1, "chunk_recursion_cluster_kernel": 1, "chunk_apply_t_kernel": 1,
                    "chunk_apply_x_kernel": 1}
    nb = K // SUB
    out = {kname: {} for kname in VARIANTS}
    for Bd in (1, 2):
        L, B = synthetic_roots(rng, Bd, m, dev)
        _, idx, w = stencil(rng, grid, 4 * K, dev)
        wv = (w[None] * torch.tensor([1.0, 1.3][:Bd], device=dev)[:, None, None]).contiguous()
        i1, wv1 = idx[:K].contiguous(), wv[:, :K].contiguous()
        flat1 = blocked_chunk(*clone_all(L, B), i1, wv1)
        flat_s = clone_all(L, B)
        for c in range(4):
            flat_s = blocked_chunk(*flat_s, idx[c * K : (c + 1) * K].contiguous(), wv[:, c * K : (c + 1) * K].contiguous())
        make = lambda: (*clone_all(L, B), i1, wv1)
        flat_ms, _ = device_ms(blocked_chunk, make, flat_kernels)
        check_sub_kernel_is_k1_at_sub_k(L, B, i1, wv1, flat1)
        p0 = torch.einsum("bkp,bkpm->bkm", wv1, B[:, i1.long()])
        for kname, kw in VARIANTS.items():
            want = blocked_chunk_plain(L, B, i1, wv1, **kw)
            before = blocked_chunk.sub_cluster_launches
            got = blocked_chunk(*clone_all(L, B), i1, wv1, **kw)
            again = blocked_chunk(*clone_all(L, B), i1, wv1, **kw)
            torch.cuda.synchronize()
            if kname == "blocked_chunk_sub" and blocked_chunk.sub_cluster_launches - before != 2:
                raise AssertionError(f"{kname} at m={m} did not take the fused cluster kernel")
            err = max_err(got, want, 1e-5, f"{kname} Bd={Bd}")
            bitwise(got, again, f"{kname} Bd={Bd}")
            want_s = plain_stream(L, B, idx, wv, K, **kw)
            got_s = clone_all(L, B)
            for c in range(4):
                got_s = blocked_chunk(*got_s, idx[c * K : (c + 1) * K].contiguous(), wv[:, c * K : (c + 1) * K].contiguous(), **kw)
            torch.cuda.synchronize()
            err_stream = max_err(got_s, want_s, 2e-4, f"{kname} 4-chunk stream Bd={Bd}")
            dist = max(float((a - b).abs().max()) for a, b in zip(got, flat1))
            dist_s = max(float((a - b).abs().max()) for a, b in zip(got_s, flat_s))

            # the yardstick applies this chunk's factors from the plain recursion
            if kname == "blocked_chunk_sub":
                U, Pm, R = blocked_factors_sub(p0, SUB)

                def library(L, B):
                    for lo in range(0, K, SUB):
                        rows = slice(lo, lo + SUB)
                        L.baddbmm_(torch.bmm(L, R[:, rows].mT), U[:, rows])
                        B.baddbmm_(torch.bmm(B, Pm[:, rows].mT), U[:, rows])

                # the local recursions, the Pallas association's two
                # correction GEMMs per pair of sub-blocks (4 sub^2 m flops),
                # the rank-K apply
                flops = Bd * (2 * K * idx.shape[1] * m + nb * 5 * SUB * (SUB - 1) * m
                              + nb * (nb - 1) // 2 * 4 * SUB * SUB * m + 8 * m * m * K)
            else:
                Ut, Pt, Rt = blocked_factors_coord(p0)
                TL, TB = Rt.mT @ Ut, Pt.mT @ Ut

                def library(L, B):
                    L.baddbmm_(torch.bmm(torch.bmm(L, p0.mT), TL), p0)
                    B.baddbmm_(torch.bmm(torch.bmm(B, p0.mT), TB), p0)

                # M = P0 P0^T (symmetric), the recursion (~7 K^3 / 3), the
                # flat factors from the lower-triangular Ut, Rt, Pt, one
                # rank-K apply
                flops = Bd * (2 * K * idx.shape[1] * m + K * (K + 1) * m + 7 * K**3 // 3
                              + 3 * K * (K + 1) * m + 8 * m * m * K)
            call = lambda L, B, i, w, kw=kw: blocked_chunk(L, B, i, w, **kw)
            plain = lambda L, B, i, w, kw=kw: blocked_chunk_plain(L, B, i, w, **kw)
            P = idx.shape[1]
            nbytes = 4 * (4 * Bd * m * m + Bd * K * P + K * P)
            bms, by = bound_ms(nbytes, flops, peaks)
            ms, stages = device_ms(call, make, profile_kernels[kname])
            out[kname][Bd] = dict(
                max_abs_err=err, stream_max_abs_err=err_stream, flat_max_abs_dist=dist,
                stream_flat_max_abs_dist=dist_s, ms=ms, flat_ms=flat_ms, stages_ms=stages,
                wrapper_ms=time_ms(call, make), plain_ms=time_ms(plain, make) if Bd == 1 else None,
                library_ms=time_ms(library, lambda: clone_all(L, B)), bound_ms=bms, bound_by=by,
            )
    out["blocked_chunk_sub"].update(check_sub_sizes(rng, dev))
    return out


def check_sub_kernel_is_k1_at_sub_k(L, B, idx, wv, flat):
    """K5 sub's fused kernel at sub = k has no boundary, so it is K1's step,
    of which K1's kernel keeps its own copy on the same layout
    (cluster_step and chunk_recursion_cluster_kernel in csrc/root_update.cu).
    Through the C entry (the wrapper takes sub < k only), its chunk must be
    bitwise the flat chunk."""
    lib = cuda_root_update._root_update_lib()
    Bd, m = L.shape[0], L.shape[-1]
    k, P = idx.shape
    plan = chunk_cluster_plan(k, m)
    Lc, Bc = clone_all(L, B)
    f32 = dict(dtype=torch.float32, device=L.device)
    factors = torch.empty((4, Bd, k, m), **f32)
    T = torch.empty((Bd, 2, m, k), **f32)
    p_ = _build.ptr
    rc = lib.ogp_blocked_chunk_sub_cluster(p_(Lc), p_(Bc), p_(idx), p_(wv), *(p_(x) for x in factors), p_(T),
                                           Bd, k, k, P, m, plan.cluster, _build.stream_of(Lc))
    _build.launch_check(rc, "chunk_sub_cluster_kernel at sub = k", plan)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((Lc, Bc), flat)):
        raise AssertionError(f"K5 sub's kernel at sub = k (Bd={Bd}) is not bitwise K1's")


def check_sub_sizes(rng, dev):
    """One K5-sub chunk on each side of the fused kernel's envelope edge
    (K1's: chunk_cluster_plan), against the plain version to 1e-5:
    SUB_EDGE_SIDE^2 near the edge, fused, its boundaries in the most rounds
    of rows (and bitwise the same on a second call); OUTSIDE_SIDE^2 beyond
    it, one sub-block at a time."""
    out = {}
    for side, fused in ((SUB_EDGE_SIDE, True), (OUTSIDE_SIDE, False)):
        grid = Grid.create([(-1.1, 1.1)] * 2, side, device=dev)
        m = grid.num_points
        if (chunk_cluster_plan(K, m) is not None) != fused:
            raise AssertionError(f"(k={K}, sub={SUB}, m={m}) was meant to lie {'in' if fused else 'out'}side "
                                 "the fused kernel's envelope")
        L, B = synthetic_roots(rng, 1, m, dev)
        _, idx, w = stencil(rng, grid, K, dev)
        wv = w[None].contiguous()
        before = (blocked_chunk.sub_launches, blocked_chunk.sub_cluster_launches)
        got = blocked_chunk(*clone_all(L, B), idx, wv, sub=SUB)
        if fused:
            bitwise(got, blocked_chunk(*clone_all(L, B), idx, wv, sub=SUB), f"blocked_chunk(sub={SUB}) m={m}")
        torch.cuda.synchronize()
        calls = 1 + fused
        if (blocked_chunk.sub_launches - before[0], blocked_chunk.sub_cluster_launches - before[1]) != (calls, calls * fused):
            raise AssertionError(f"blocked_chunk(sub={SUB}) at m={m} did not take the {'fused' if fused else 'per sub-block'} path")
        err = max_err(got, blocked_chunk_plain(L, B, idx, wv, sub=SUB), 1e-5, f"blocked_chunk(sub={SUB}) m={m}")
        out["fused near the edge" if fused else "outside"] = dict(m=m, k=K, sub=SUB, max_abs_err=err)
    return out


def spd_batch(rng, shape, dev):
    """SPD matrices a a^T / m + I of the given shape (..., m, m)."""
    a = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
    return (a @ a.mT / shape[-1] + torch.eye(shape[-1], device=dev)).contiguous()


def check_cholesky_case(q, what):
    """K6 on q against its plain version and torch.linalg.cholesky (atol
    2e-5, rtol 1e-4), bitwise the same on a second call, strict upper
    triangle exactly 0, and blocked_cholesky_ex bitwise the same with its
    failure flag clear. Returns the factor and the max abs errors."""
    got = blocked_cholesky(q, CHOL_BLOCK)
    again, info = blocked_cholesky_ex(q, CHOL_BLOCK)
    torch.cuda.synchronize()
    bitwise((got,), (again,), f"blocked_cholesky {what}")
    if bool((info != 0).any()):
        raise AssertionError(f"blocked_cholesky_ex {what}: the failure flag is set on an SPD batch")
    errs = {}
    for name, want in (("plain", blocked_cholesky_plain(q, CHOL_BLOCK)), ("torch.linalg.cholesky", torch.linalg.cholesky(q))):
        errs[name] = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=2e-5, rtol=1e-4):
            raise AssertionError(f"blocked_cholesky {what}: max abs err {errs[name]:.3e} against {name}")
    if not bool((torch.triu(got, 1) == 0).all()):
        raise AssertionError(f"blocked_cholesky {what}: the strict upper triangle is not exactly 0")
    return got, errs


def check_cholesky(rng, Q, peaks, dev):
    """K6 on SPD batches at CHOL_SIZES x CHOL_BATCHES and on a (2, 2, m, m)
    batch, then times at m = 900 for Bd = 1 (phase 4's Q) and Bd = 4 of
    blocked_cholesky_ex, the entry with the failure flag that spd_cholesky
    calls: the device span with programmatic dependent launch (ms) and
    without (plain_launch_ms), each kernel's summed durations, and the device spans
    of torch.linalg.cholesky (library_ms) and torch.linalg.cholesky_ex."""
    m = Q.shape[-1]
    for mc in CHOL_SIZES:
        for Bd in CHOL_BATCHES:
            _, errs = check_cholesky_case(spd_batch(rng, (Bd, mc, mc), dev), f"Bd={Bd} m={mc}")
            print(f"  K6 Bd={Bd} m={mc}: max abs err {json.dumps(errs)}")
    q4d = spd_batch(rng, (2, 2, m, m), dev)
    got4d, errs = check_cholesky_case(q4d, f"(2, 2, {m}, {m})")
    if got4d.shape != q4d.shape:
        raise AssertionError(f"blocked_cholesky returned {tuple(got4d.shape)} for {tuple(q4d.shape)}")
    print(f"  K6 (2, 2, {m}, {m}): max abs err {json.dumps(errs)}")

    # Q's entries grow with the data: phase 4 holds its factor to a relative
    # bound; here it must come back the same from a second call
    Lq, again = blocked_cholesky(Q, CHOL_BLOCK), blocked_cholesky(Q, CHOL_BLOCK)
    torch.cuda.synchronize()
    bitwise((Lq,), (again,), f"blocked_cholesky on Q (m={m})")
    want = blocked_cholesky_plain(Q, CHOL_BLOCK)
    nb = -(-m // CHOL_BLOCK)
    stage_kernels = {"chol_init_kernel": 1, "chol_factor_kernel": nb, "chol_solve_kernel": nb - 1,
                     "chol_syrk_kernel": nb - 1}
    out = {}
    for Bd, q in ((1, Q), (4, spd_batch(rng, (4, m, m), dev))):
        make = lambda q=q: (q, CHOL_BLOCK)
        bms, by = chol_bound(Bd, m, peaks)
        r = dict(bound_ms=bms, bound_by=by)
        for key, pdl in (("", True), ("plain_launch_", False)):
            cuda_chol.PROGRAMMATIC_LAUNCH = pdl
            try:
                r[f"{key}ms"], r[f"{key}stages_ms"] = device_span_ms(blocked_cholesky_ex, make, stage_kernels)
                r[f"{key}kernel_sum_ms"] = sum(r[f"{key}stages_ms"].values())
            finally:
                cuda_chol.PROGRAMMATIC_LAUNCH = True
        r["library_ms"] = device_span_ms(lambda q, b: torch.linalg.cholesky(q), make)[0]
        r["library_ex_ms"] = device_span_ms(lambda q, b: torch.linalg.cholesky_ex(q), make)[0]
        r["library_wall_ms"] = time_ms(lambda q, b: torch.linalg.cholesky(q), make)
        r["wrapper_ms"] = time_ms(blocked_cholesky_ex, make)
        if Bd == 1:
            r.update(max_abs_err=float((Lq - want).abs().max()), rel_max_err=rel_max_err(Lq, want),
                     max_abs_err_vs_library=float((Lq - torch.linalg.cholesky(Q)).abs().max()),
                     plain_ms=time_ms(blocked_cholesky_plain, make))
        out[Bd] = r
    return out


# --------------------------------------------------------------------------
# phase 5: the training path through OnlineSKIRegression
# --------------------------------------------------------------------------


def _gp_leaves(params):
    return [params["kernel"]["raw_lengthscale"], params["kernel"]["raw_outputscale"], params["raw_second_noise"]]


def _named_leaves(params, prefix=""):
    """[(name, tensor)] of a nested params dict, in its order."""
    out = []
    for key, val in params.items():
        out += _named_leaves(val, f"{prefix}{key}/") if isinstance(val, dict) else [(prefix + key, val)]
    return out


def load_twin(reg, x0, y0, cls=OnlineSKIRegression, **kw):
    """A wrapper of class ``cls`` on the CPU built with reg's configuration
    ``kw``, started from reg's params, stem and state as they stand
    (convert.load_wrapper); the dense or the rank-capped state, as reg has."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a routed configuration may warn
        twin = cls(LinearStem(2, 2), x0, y0, device="cpu", **kw)
    host = lambda t: None if t is None else t.detach().cpu().numpy()
    stem_params = {"lin": {"w": host(reg.stem.lin.weight).T, "b": host(reg.stem.lin.bias)}}
    bn = {"bn": {"mean": host(reg.stem.bn.running_mean), "var": host(reg.stem.bn.running_var),
                 "momentum": host(reg.stem.bn.momentum)}}
    params = {key: {k: host(v) for k, v in val.items()} if isinstance(val, dict) else host(val)
              for key, val in reg.params.items()}
    s = reg.state
    if hasattr(s, "used"):
        state = dict(wty=host(s.wty), ydy=host(s.ydy), root=host(s.root), used=s.used, d_logdet=host(s.d_logdet),
                     num_data=s.num_data)
    else:
        state = dict(wty=host(s.wty), ydy=host(s.ydy), mat=host(s.roots.mat), root=host(s.roots.root),
                     inv_root=host(s.roots.inv_root), d_logdet=host(s.d_logdet), num_data=s.num_data)
    convert.load_wrapper(twin, params, stem_params, bn, state, device="cpu")
    return twin


def training_path(rng, card, dev):
    """Phase 5's path: OnlineSKIRegression at bench.py's full-update
    configuration on the card: fit, 64 update()s at q = 1, 8 at q = 32, one
    hyper_step, predict, prequential and absorb, with the launch counters
    zeroed just before and read just after. The first 8 q = 1 updates run
    on a CPU twin too (convert). Returns (reg, launches, seed data)."""
    f32 = np.float32
    x0 = rng.uniform(-1, 1, (N_SEED, 2)).astype(f32)
    y0 = np.sin(3 * x0[:, :1])

    def points(n):
        x = rng.uniform(-1, 1, (n, 2)).astype(f32)
        return x, np.sin(3 * x[:, :1])

    x1, y1 = points(N_UPD1)
    x32, y32 = points(N_UPD32 * 32)
    xh, yh = points(32)
    xt, yt = points(N_TEST)
    xp, yp = points(N_TEST)
    xa, ya = points(N_ABSORB)
    reg = OnlineSKIRegression(LinearStem(2, 2), x0, y0, lr=TRAIN_LR, grid_size=M_SIDE, slim_state=True, device=dev)
    torch.cuda.synchronize()

    zero_counters()
    t0 = time.perf_counter()
    records = reg.fit(x0, y0, FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    twin = load_twin(reg, x0, y0, lr=TRAIN_LR, grid_size=M_SIDE, slim_state=True)
    per_update = []  # (K6, K2) launches of each update
    losses, upd1_s, upd32_s = [], [], []
    for i in range(N_UPD1 + N_UPD32):
        x, y = (x1[i : i + 1], y1[i : i + 1]) if i < N_UPD1 else (
            x32[(i - N_UPD1) * 32 : (i - N_UPD1 + 1) * 32], y32[(i - N_UPD1) * 32 : (i - N_UPD1 + 1) * 32])
        before = (blocked_cholesky.launches, rank1_apply.launches)
        r0 = time.perf_counter()
        losses.append(reg.update(x, y))  # returns floats: the host waits for the card
        (upd1_s if i < N_UPD1 else upd32_s).append(time.perf_counter() - r0)
        per_update.append((blocked_cholesky.launches - before[0], rank1_apply.launches - before[1]))
        if i < N_TWIN:
            losses[-1] += twin.update(x, y)
        if i == N_TWIN - 1:
            twin_errs = compare_twin(reg, twin)
    # what the hyper step starts from, for check_hyper_gradient after the path
    # (prequential and absorb update the state's roots in place on the card)
    snapshot = ({k: (v.detach().clone() if torch.is_tensor(v) else {a: b.detach().clone() for a, b in v.items()})
                 for k, v in reg.params.items()},
                reg.state._replace(wty=reg.state.wty.clone(), roots=RootCache(
                    None, reg.state.roots.root.clone(), reg.state.roots.inv_root.clone())))
    k6_before = blocked_cholesky.launches
    losses.append(reg.hyper_step(xh, yh))
    k6_hyper = blocked_cholesky.launches - k6_before
    mean, var = reg.predict(xt)
    pm, pv = reg.prequential(xp, yp)
    reg.absorb(xa, ya)
    torch.cuda.synchronize()
    launches = read_counters()

    print(f"training path (OnlineSKIRegression, LinearStem(2, 2), m={M_SIDE**2}, slim state, lr {TRAIN_LR}) on {card}:")
    print(f"  fit {FIT_EPOCHS} epochs on {N_SEED} points: {fit_s:.4f} s; train losses "
          f"{json.dumps([r['train_loss'] for r in records])}")
    for label, q, times in (("q = 1", 1, upd1_s), ("q = 32", 32, upd32_s)):
        rates = [q / t for t in times[1:]]
        print(f"  update() {label}, {len(rates)} calls after a warm-up: median {np.median(rates):.1f} points/s "
              f"({1e3 * np.median(times[1:]):.3f} ms a call), spread {min(rates):.1f}-{max(rates):.1f}")
    k6_per = [k for k, _ in per_update]
    print(f"  K6 launches per update(): {sorted(set(k6_per))} (mean {np.mean(k6_per):.3f}); per hyper_step: {k6_hyper}")
    print(f"  CPU twin after {N_TWIN} q = 1 updates: {json.dumps(twin_errs)}")
    print(f"  kernel launches: {json.dumps(launches)}")

    if any(k < 1 for k in k6_per) or k6_hyper < 1:
        raise AssertionError("an update() or the hyper_step did not factor Q with K6")
    if any(k2 != 1 for _, k2 in per_update[:N_UPD1]):
        raise AssertionError(f"K2 did not launch once per q = 1 update: {[k2 for _, k2 in per_update[:N_UPD1]]}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the training path never launched {name}")
    if (launches["chunk_recursion_cluster"], launches["pred_recursion_cluster"]) != (
            launches["blocked_chunk"], launches["pred_chunk"]):
        raise AssertionError("a chunk of the training path did not run its recursion on a cluster")
    values = [v for pair in losses for v in pair] + [r["train_loss"] for r in records] + [reg.mll_value()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"a non-finite loss or MLL on the training path: {values}")
    for name, t in (("mean", mean), ("var", var), ("prequential mean", pm), ("prequential var", pv)):
        if tuple(t.shape) != (N_TEST, 1) or not torch.isfinite(t).all():
            raise AssertionError(f"training path: {name} is not finite of shape ({N_TEST}, 1)")
    rmse = float(torch.sqrt(torch.mean((mean[:, 0].cpu() - torch.tensor(yt[:, 0])) ** 2)))
    print(f"  held-out RMSE vs sin(3 x0): {rmse:.6f}; mll_value {reg.mll_value():.6f}")
    return reg, launches, (x0, y0), snapshot


def compare_twin(reg, twin):
    """reg (the card) against its CPU twin: params within TWIN_PARAM_TOL
    (a tenth of one Adam step), roots within 1e-3 * scale (bench.py's
    gate)."""
    errs = {}
    pairs = [(n, p, q) for (n, p), (_, q) in zip(_named_leaves(reg.params), _named_leaves(twin.params))]
    pairs += [(f"stem {n}", p, q) for (n, p), q in zip(reg.stem.named_parameters(), twin.stem.parameters())]
    for name, a, b in pairs:
        errs[name] = float((a.detach().cpu() - b.detach()).abs().max())
        if not errs[name] <= TWIN_PARAM_TOL:
            raise AssertionError(f"CPU twin: {name} differs by {errs[name]:.3e} (tol {TWIN_PARAM_TOL})")
    for name in ("root", "inv_root"):
        a, b = getattr(reg.state.roots, name).cpu(), getattr(twin.state.roots, name)
        errs[name] = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not errs[name] <= 1e-3 * max(scale, 1.0):
            raise AssertionError(f"CPU twin: {name} differs by {errs[name]:.3e} (scale {scale:.3e})")
    return errs


def autograd_mll(model, params, state):
    """-sum(wiski_mll) with skip_logdet_forward, written out with
    torch.linalg.cholesky and left to autograd (no closed form): the
    yardstick of the check of _DenseInnerCore's backward."""
    s2 = torch.exp(params["raw_second_noise"])
    E = grid_kuu_dense(model.kernel, params["kernel"], model.grid) / s2[:, None, None]
    L, wty = state.roots.root, state.wty
    with f32_matmul_precision():
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        Lq = torch.linalg.cholesky(eye + L.mT @ (E @ L))
        Kw = E @ wty
        proj = L.mT @ Kw
        qf = torch.sum(proj * torch.cholesky_solve(proj, Lq), dim=(-2, -1))
        ld = 2.0 * torch.sum(torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1)), dim=-1)
    ld = ld - ld.detach()
    n = float(state.num_data)
    quad = (state.ydy - torch.sum(wty * Kw, dim=(-2, -1)) + qf) / s2
    return torch.sum(0.5 * (quad + ld + state.d_logdet + n * LOG_2PI + n * torch.log(s2)) / n)


def split_ms(loss_fn, leaves, reps=TIMING_REPS):
    """Median device ms of the forward (loss_fn()) and of the backward
    (torch.autograd.grad), between CUDA events recorded behind a long spin
    kernel, so that the host has queued both before the card reaches them."""
    fwd, bwd = [], []
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        torch.cuda._sleep(5 * SPIN_CYCLES)
        ev[0].record()
        loss = loss_fn()
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        torch.cuda.synchronize()
        if r:
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[1].elapsed_time(ev[2]))
    return float(np.median(fwd)), float(np.median(bwd))


def check_hyper_gradient(model, params, state, card):
    """The gradient of one hyper step (the training path's, from its params
    and state) at float32 on the card: _DenseInnerCore's closed form against
    autograd through torch.linalg.cholesky (the value too), each leaf to
    HYPER_GRAD_RTOL of its largest entry; both beside a float64 reference on
    the card. Then the device time of the forward and of each backward."""
    for leaf in _gp_leaves(params):
        leaf.requires_grad_(True)
    cfg_skip = DEFAULT_CONFIG.replace(skip_logdet_forward=True)
    leaves = _gp_leaves(params)
    closed = lambda: -torch.sum(wiski_mll(model, params, state, cfg_skip))
    plain = lambda: autograd_mll(model, params, state)
    v_cf, v_ad = closed(), plain()
    g_cf = torch.autograd.grad(v_cf, leaves)
    g_ad = torch.autograd.grad(v_ad, leaves)
    p64 = {"kernel": {k: v.detach().double().requires_grad_(True) for k, v in params["kernel"].items()},
           "raw_second_noise": params["raw_second_noise"].detach().double().requires_grad_(True)}
    s64 = state._replace(wty=state.wty.double(), ydy=state.ydy.double(), d_logdet=state.d_logdet.double(),
                         roots=RootCache(None, state.roots.root.double(), state.roots.inv_root.double()))
    g_64 = torch.autograd.grad(-torch.sum(wiski_mll(model, p64, s64, cfg_skip)), _gp_leaves(p64))
    out = {"value": float(v_cf.detach()), "value_autograd": float(v_ad.detach())}
    for name, a, b, c in zip(("raw_lengthscale", "raw_outputscale", "raw_second_noise"), g_cf, g_ad, g_64):
        scale = float(b.abs().max())
        out[name] = dict(closed_vs_autograd=float((a - b).abs().max()) / scale,
                         closed_vs_f64=float((a.double() - c).abs().max()) / scale,
                         autograd_vs_f64=float((b.double() - c).abs().max()) / scale)
        if not out[name]["closed_vs_autograd"] <= HYPER_GRAD_RTOL:
            raise AssertionError(f"hyper gradient {name}: closed form and autograd differ: {out[name]}")
    if not abs(out["value"] - out["value_autograd"]) <= HYPER_GRAD_RTOL * abs(out["value_autograd"]):
        raise AssertionError(f"hyper step value: closed form {out['value']} vs autograd {out['value_autograd']}")
    fwd, bwd = split_ms(closed, leaves)
    fwd_ad, bwd_ad = split_ms(plain, leaves)
    out.update(forward_ms=fwd, closed_backward_ms=bwd, autograd_forward_ms=fwd_ad, autograd_backward_ms=bwd_ad)
    print(f"hyper step at n={state.num_data} on {card}: " + json.dumps(out))
    return out


def check_k6_flag(model, params, state, card):
    """K6's flag on the card: on the Q of (params, state) with one eigenvalue
    set to -1, spd_cholesky gives NaN in the lower triangle where cholesky_ex
    reports failure; the SPD Q beside it in the batch is factored bitwise as
    alone."""
    with torch.no_grad():
        Q = q_matrix(model, params, state)[0]
    lam, V = torch.linalg.eigh(Q.double())
    lam[0] = -1.0
    bad = ((V * lam) @ V.mT).float()
    batch = torch.stack([bad, Q]).contiguous()
    got = spd_cholesky(batch)
    _, info = blocked_cholesky_ex(batch)
    _, info_lib = torch.linalg.cholesky_ex(batch)
    alone = blocked_cholesky(Q.contiguous())
    torch.cuda.synchronize()
    rows, cols = torch.tril_indices(Q.shape[-1], Q.shape[-1], device=Q.device)
    nan_lower = bool(torch.isnan(got[0][rows, cols]).all())
    print(f"K6 flag on {card}: info {info.tolist()} (cholesky_ex {info_lib.tolist()}), "
          f"NaN lower triangle on the indefinite Q: {nan_lower}")
    if not (info[0] != 0 and info_lib[0] != 0 and nan_lower):
        raise AssertionError("spd_cholesky did not give NaN on an indefinite Q")
    err = rel_max_err(got[1], alone)
    print(f"  the SPD Q beside it: relative max err {err:.3e} against K6 on it alone")
    if not (info[1] == 0 and info_lib[1] == 0 and torch.isfinite(got[1]).all() and err <= 1e-6):
        raise AssertionError("spd_cholesky changed the factor of an SPD Q")


def time_fit_epochs(reg, x0, y0, card):
    """fit(num_epochs=1), HOST_REPEATS calls after a warm-up: one epoch and
    the final refresh of the state, each call synchronised."""
    times = []
    for _ in range(1 + HOST_REPEATS):
        r0 = time.perf_counter()
        reg.fit(x0, y0, 1)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - r0))
    print(f"  fit(num_epochs=1) on {N_SEED} points, {HOST_REPEATS} calls after a warm-up on {card}: median "
          f"{np.median(times[1:]):.3f} ms, spread {min(times[1:]):.3f}-{max(times[1:]):.3f}")
    return times[1:]


def profile_update(reg, rng, card, n=4):
    """Where an update() at q = 1 spends its time: n calls under
    torch.profiler (CPU and CUDA), after a warm-up. Prints the wall time a
    call, the CUDA kernels' summed time and launches a call, the device's
    idle share (1 - kernel time / wall time, the profiler on), the kernels
    by device time and the host ops by self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = rng.uniform(-1, 1, (n + 1, 2)).astype(np.float32)
    y = np.sin(3 * x[:, :1])
    reg.update(x[n:], y[n:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for i in range(n):
            reg.update(x[i : i + 1], y[i : i + 1])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        # device activity; the spans of record_function ranges (such as
        # Optimizer.step) are annotations over it, not activity of their own
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            count, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, us + e.time_range.end - e.time_range.start)
    busy_us = sum(us for _, us in by_name.values())
    launches = sum(c for c, _ in by_name.values())
    print(f"update() q = 1 under torch.profiler on {card}: {wall_us / n / 1e3:.3f} ms a call, CUDA kernels "
          f"{busy_us / n / 1e3:.3f} ms and {launches / n:.1f} launches a call, device idle share "
          f"{1 - busy_us / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (count, us) in top:
        print(f"  {us / n / 1e3:8.4f} ms  {count / n:5.1f} x  {name[:110]}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


# --------------------------------------------------------------------------
# phase 6: the large-grid regime at m = 4,096
# --------------------------------------------------------------------------


def large_model(dev, seed_rng):
    """bench_iterative_hyper_step's model and state: a 64x64 grid, RBF,
    learned second noise, N_SEED6 points of sin(3 x0)."""
    grid = Grid.create([(-1.1, 1.1)] * 2, M6_SIDE, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(2)
    x0 = torch.tensor(seed_rng.uniform(-1, 1, (N_SEED6, 2)), dtype=torch.float32, device=dev)
    y0 = torch.sin(3 * x0[:, :1])
    return model, params, wiski_init(model, x0, y0, torch.ones_like(y0))


def check_kernels_large(rng, model, params, state, peaks, dev):
    """K2 (16 calls), K1 and K3 (one chunk each, on their single-block
    recursion kernels) and K6 (Q of the state) at m = 4,096 against their
    plain versions on the card, with device times, bounds and yardsticks."""
    grid = model.grid
    m = grid.num_points
    L, B = synthetic_roots(rng, 1, m, dev)
    out = {}
    _, idx2, w2 = stencil(rng, grid, N_K2_6, dev)
    out["rank1_apply"] = check_k2(L, B, idx2, w2[None], peaks, f"m={m}", PLAIN_REPS6)
    out["rank1_apply"]["route"] = "row kernel looping over each row (m > 32 kRowRegs)"
    _, idx, w = stencil(rng, grid, K, dev)
    if chunk_cluster_plan(K, m) is not None:
        raise AssertionError(f"(k={K}, m={m}) was expected outside K1's cluster envelope")
    out["blocked_chunk"] = check_k1(L, B, idx, w[None].contiguous(), peaks, f"m={m}", False, PLAIN_REPS6)

    # K3: one chunk on the model's caches
    with torch.no_grad():
        mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    C, mu = cov_cache.contiguous(), mean_cache[..., 0].contiguous()
    x, idx, w = stencil(rng, grid, K, dev)
    if pred_cluster_plan(K, m, idx.shape[1]) is not None:
        raise AssertionError(f"(k={K}, m={m}) was expected outside K3's cluster envelope")
    y = torch.sin(3 * x[:, 0])[None].contiguous()
    nz = torch.ones((1, K), device=dev)
    before = (pred_chunk.launches, pred_chunk.cluster_launches)
    got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
    again = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
    torch.cuda.synchronize()
    if (pred_chunk.launches - before[0], pred_chunk.cluster_launches - before[1]) != (2, 0):
        raise AssertionError(f"pred_chunk at m={m} did not take the single-block recursion")
    err = max_err(got, pred_chunk_stencil_plain(C, mu, idx, w, y, nz), 2e-4, f"pred_chunk m={m}")
    bitwise(got, again, f"pred_chunk m={m}")
    S = stencil_rows(idx, w, m)
    library = pred_library(*pred_chunk_factors(S, S @ C, mu @ S.mT, y, nz)[:2])
    make = lambda: (*clone_all(C, mu), idx, w, y, nz)
    bms, by = pred_bound(1, m, K, idx.shape[1], peaks)
    ms, stages = device_ms(pred_chunk, make, {"pred_gather_kernel": 1, "pred_recursion_kernel": 1,
                                              "pred_apply_kernel": 1})
    out["pred_chunk"] = dict(
        k=K, max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(pred_chunk, make),
        plain_ms=time_ms(pred_chunk_stencil_plain, make, PLAIN_REPS6),
        library_ms=time_ms(library, lambda: clone_all(C, mu)), bound_ms=bms, bound_by=by,
        route="single-block recursion (pred_recursion_kernel)")
    out["blocked_cholesky"] = check_k6(q_matrix(model, params, state), peaks, f"Q (m={m})", PLAIN_REPS6)
    return out


def check_k2(L, B, idx, wv, peaks, what, plain_reps=TIMING_REPS):
    """K2 against its plain version on each point of a stencil stream in
    turn (idx (n, P); wv (Bd, n, P), the weights over sqrt(noise)), the
    roots carried from call to call, to 1e-5; then device time, bound and
    yardstick on the first point."""
    Lk, Bk = clone_all(L, B)
    err = 0.0
    for i in range(idx.shape[0]):
        p = torch.einsum("bp,bpm->bm", wv[:, i], Bk[:, idx[i].long()]).contiguous()
        want = rank1_apply_plain(Lk, Bk, p)
        got = rank1_apply(Lk, Bk, p)
        torch.cuda.synchronize()
        err = max(err, max_err(got, want, 1e-5, f"rank1_apply {what} call {i}"))
    p = torch.einsum("bp,bpm->bm", wv[:, 0], B[:, idx[0].long()]).contiguous()
    make = lambda: (*clone_all(L, B), p)
    bms, by = rank1_bound(L.shape[0], L.shape[-1], peaks)
    ms, stages = device_ms(rank1_apply, make, {"rank1_prepass_kernel": 1, "rank1_rows_kernel": 1})
    return dict(
        calls=idx.shape[0], max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(rank1_apply, make),
        plain_ms=time_ms(rank1_apply_plain, make, plain_reps), library_ms=time_ms(rank1_library, make),
        bound_ms=bms, bound_by=by)


def check_k1(L, B, idx, wv, peaks, what, cluster, plain_reps=TIMING_REPS):
    """One K1 chunk (idx (k, P), wv (Bd, k, P)) against its plain version to
    1e-5 and bitwise the same on a second call, its recursion on a cluster
    or on the single-block kernel as ``cluster`` says (by the counters);
    then device time, bound and yardstick."""
    before = (blocked_chunk.launches, blocked_chunk.cluster_launches)
    got = blocked_chunk(*clone_all(L, B), idx, wv)
    again = blocked_chunk(*clone_all(L, B), idx, wv)
    torch.cuda.synchronize()
    if (blocked_chunk.launches - before[0], blocked_chunk.cluster_launches - before[1]) != (2, 2 * cluster):
        route = "cluster" if cluster else "single-block"
        raise AssertionError(f"blocked_chunk {what} did not take the {route} recursion")
    err = max_err(got, blocked_chunk_plain(L, B, idx, wv), 1e-5, f"blocked_chunk {what}")
    bitwise(got, again, f"blocked_chunk {what}")
    library = chunk_library(*blocked_factors(torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()])))
    make = lambda: (*clone_all(L, B), idx, wv)
    k, P = idx.shape
    bms, by = chunk_bound(L.shape[0], L.shape[-1], k, P, peaks)
    recursion = "chunk_recursion_cluster_kernel" if cluster else "chunk_recursion_kernel"
    ms, stages = device_ms(blocked_chunk, make, {"chunk_gather_kernel": 1, recursion: 1,
                                                 "chunk_apply_t_kernel": 1, "chunk_apply_x_kernel": 1})
    return dict(
        k=k, max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(blocked_chunk, make),
        plain_ms=time_ms(blocked_chunk_plain, make, plain_reps),
        library_ms=time_ms(library, lambda: clone_all(L, B)), bound_ms=bms, bound_by=by,
        route=f"{'cluster' if cluster else 'single-block'} recursion ({recursion})")


def check_k6(Q, peaks, what, plain_reps=TIMING_REPS):
    """K6 on Q (..., m, m) against its plain version and
    torch.linalg.cholesky (relative max error <= 5e-4), bitwise the same on
    a second call, strict upper triangle exactly 0; then the device span of
    blocked_cholesky_ex, bound and the library's span."""
    m = Q.shape[-1]
    Lq, again = blocked_cholesky(Q, CHOL_BLOCK), blocked_cholesky(Q, CHOL_BLOCK)
    torch.cuda.synchronize()
    bitwise((Lq,), (again,), f"blocked_cholesky on {what}")
    want = blocked_cholesky_plain(Q, CHOL_BLOCK)
    e_plain, e_lib = rel_max_err(Lq, want), rel_max_err(Lq, torch.linalg.cholesky(Q))
    if not (e_plain <= 5e-4 and e_lib <= 5e-4):
        raise AssertionError(f"K6 on {what}: relative max err {e_plain:.3e} vs plain, {e_lib:.3e} vs library")
    if not bool((torch.triu(Lq, 1) == 0).all()):
        raise AssertionError(f"K6 on {what}: the strict upper triangle is not exactly 0")
    nb = -(-m // CHOL_BLOCK)
    make = lambda: (Q, CHOL_BLOCK)
    bms, by = chol_bound(Q[..., 0, 0].numel(), m, peaks)
    ms, stages = device_span_ms(blocked_cholesky_ex, make, {"chol_init_kernel": 1, "chol_factor_kernel": nb,
                                                            "chol_solve_kernel": nb - 1, "chol_syrk_kernel": nb - 1})
    return dict(
        panels=nb, max_abs_err=float((Lq - want).abs().max()), rel_max_err=e_plain, rel_max_err_vs_library=e_lib,
        ms=ms, stages_ms=stages, wrapper_ms=time_ms(blocked_cholesky_ex, make),
        plain_ms=time_ms(blocked_cholesky_plain, make, plain_reps),
        library_ms=device_span_ms(lambda q, b: torch.linalg.cholesky(q), make)[0], bound_ms=bms, bound_by=by,
        route=f"{nb} panels of {CHOL_BLOCK}")


def iterative_hyper_step(model, params, state, card):
    """bench_iterative_hyper_step: the gate (CG/SLQ MLL against the dense
    one, Q on K6), then HYPER_STEPS Adam steps, 1 + HYPER_REPEATS times,
    each with new probes; hyper steps/s and the peak device memory."""
    m = model.grid.num_points
    cfg_iter = DEFAULT_CONFIG.replace(max_cholesky_size=2048, use_toeplitz=True)
    cfg_dense = DEFAULT_CONFIG.replace(max_cholesky_size=2 * m)
    with torch.no_grad():
        v_iter = float(torch.sum(wiski_mll(model, params, state, cfg_iter, generator=torch.Generator().manual_seed(0))))
        k6 = blocked_cholesky.launches
        v_dense = float(torch.sum(wiski_mll(model, params, state, cfg_dense)))
        if blocked_cholesky.launches - k6 != 1:
            raise AssertionError("the dense MLL at m = 4,096 did not factor Q with K6")
    rel = abs(v_iter - v_dense) / max(abs(v_dense), 1.0)
    print(f"iterative MLL at m={m} on {card}: {v_iter:.6f} against the dense {v_dense:.6f}, rel {rel:.3e}")
    if not rel <= ITER_GATE_REL:
        raise AssertionError(f"iterative/dense MLL mismatch {rel:.3e} at m={m}")

    base = {"kernel": {k: v.detach().clone() for k, v in params["kernel"].items()},
            "raw_second_noise": params["raw_second_noise"].detach().clone()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rates, losses = [], []
    for rep in range(1 + HYPER_REPEATS):
        p = {"kernel": {k: v.clone().requires_grad_(True) for k, v in base["kernel"].items()},
             "raw_second_noise": base["raw_second_noise"].clone().requires_grad_(True)}
        leaves = _gp_leaves(p)
        opt = torch.optim.Adam(leaves, lr=HYPER_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(HYPER_STEPS):
            loss = -torch.sum(wiski_mll(model, p, state, cfg_iter,
                                        generator=torch.Generator().manual_seed((1 << 32) + i)))
            for leaf, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                leaf.grad = g
            opt.step()
            if rep == 0 and i == 0:
                losses.append(float(loss.detach()))
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        if rep:
            rates.append(HYPER_STEPS / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite iterative-MLL loss: {losses}")
    profile_hyper_step(lambda: -torch.sum(wiski_mll(model, p, state, cfg_iter, generator=torch.Generator().manual_seed(1))),
                       leaves, card)
    out = dict(gate_rel=rel, value_iterative=v_iter, value_dense=v_dense, first_loss=losses[0],
               last_losses=losses[1:], steps_per_s_median=float(np.median(rates)), steps_per_s=rates,
               peak_bytes=peak, held_bytes_before=held)
    print(f"  {HYPER_STEPS} hyper steps, {HYPER_REPEATS} repeats after a warm-up: median "
          f"{out['steps_per_s_median']:.3f} steps/s, spread {min(rates):.3f}-{max(rates):.3f}; peak device "
          f"memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before); losses {json.dumps(losses)}")
    return out


def profile_hyper_step(loss_fn, leaves, card):
    """One hyper step's value and gradient under torch.profiler (CPU and
    CUDA): wall time, the CUDA kernels' summed time and launches, and the
    device's idle share (the profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.autograd.grad(loss_fn(), leaves)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        torch.autograd.grad(loss_fn(), leaves)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    print(f"  one hyper step under torch.profiler on {card}: {wall_us / 1e3:.3f} ms, CUDA kernels "
          f"{sum(busy) / 1e3:.3f} ms in {len(busy)} launches, device idle share {1 - sum(busy) / wall_us:.3f}")


def lowrank_stream(rng, card, dev):
    """bench_lowrank_stream: the exact-regime gate against a dense SKI oracle
    (float64), then LR_CHUNKS chunks of LR_CHUNK points with compressions
    firing, 1 + LR_REPEATS times from the same state; points/s."""
    grid = Grid.create([(-1.1, 1.1)] * 2, M6_SIDE, device=dev)
    m = grid.num_points
    model = WiskiLowRankModel(RBFKernel(), grid, rank=LR_RANK)
    params = model.init_params(2)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.uniform(-1, 1, (LR_SEED, 2)), **f32)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_lowrank_init(model, x0, y0, torch.ones_like(y0), params=params)
    if state.used != LR_SEED:
        raise AssertionError(f"the seed absorb compressed (used {state.used}); the gate needs the exact regime")
    xt = torch.tensor(rng.uniform(-1, 1, (64, 2)), **f32)
    mean, _ = wiski_lowrank_predict(model, params, state, xt)
    p64 = {"kernel": {k: v.double() for k, v in params["kernel"].items()}}
    kuu = grid_kuu_dense(model.kernel, p64["kernel"], grid).double()
    W = dense_w(*interp_coeffs(grid, x0, detach=True), m).T.double()
    Wt = dense_w(*interp_coeffs(grid, xt, detach=True), m).T.double()
    Kn = W @ kuu @ W.T + torch.eye(LR_SEED, dtype=torch.float64, device=dev)
    want = (Wt @ kuu @ W.T @ torch.linalg.solve(Kn, y0.double()))[:, 0]
    err = float((mean.double() - want).abs().max())
    scale = float(want.abs().max())
    print(f"rank-capped stream (m={m}, rank {LR_RANK}) on {card}: exact-regime mean err {err:.3e} "
          f"(scale {scale:.3e}) against the dense SKI oracle")
    if not err <= LR_GATE * max(scale, 1.0):
        raise AssertionError(f"lowrank/dense posterior-mean drift {err:.3e} at m={m}")

    xs = torch.tensor(rng.uniform(-1, 1, (LR_CHUNKS, LR_CHUNK, 2)), **f32)
    ys = torch.sin(3 * xs[..., :1])
    ns = torch.ones_like(ys)
    rates = []
    for rep in range(1 + LR_REPEATS):
        st, compressions = state, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(LR_CHUNKS):
            used = st.used
            st = wiski_lowrank_condition(model, st, xs[c], ys[c], ns[c], params)
            compressions += st.used < used
        torch.cuda.synchronize()
        if rep:
            rates.append(LR_CHUNKS * LR_CHUNK / (time.perf_counter() - t0))
    if st.num_data != LR_SEED + LR_CHUNKS * LR_CHUNK or not compressions:
        raise AssertionError(f"the stream absorbed {st.num_data} points with {compressions} compressions")
    if not torch.isfinite(st.root).all():
        raise AssertionError("non-finite rank-capped root after the stream")
    out = dict(gate_err=err, gate_scale=scale, points=LR_CHUNKS * LR_CHUNK, compressions=compressions,
               points_per_s_median=float(np.median(rates)), points_per_s=rates)
    print(f"  {LR_CHUNKS} chunks of {LR_CHUNK}, {compressions} compressions, {LR_REPEATS} repeats after a "
          f"warm-up: median {out['points_per_s_median']:.1f} points/s, spread {min(rates):.1f}-{max(rates):.1f}")
    return out


def _compare_twin_predictions(reg, twin, xt, what):
    errs = {}
    for name, a, b in zip(("mean", "var"), reg.predict(xt), twin.predict(xt)):
        a, b = a.cpu(), b
        errs[name] = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not (torch.isfinite(a).all() and errs[name] <= 1e-3 * max(scale, 1e-30)):
            raise AssertionError(f"{what} CPU twin: predicted {name} differs by {errs[name]:.3e} (scale {scale:.3e})")
    for name, a, b in zip(("raw_lengthscale", "raw_outputscale", "raw_second_noise"),
                          _gp_leaves(reg.params), _gp_leaves(twin.params)):
        errs[name] = float((a.detach().cpu() - b.detach()).abs().max())
        if not errs[name] <= TWIN_PARAM_TOL:
            raise AssertionError(f"{what} CPU twin: {name} differs by {errs[name]:.3e} (tol {TWIN_PARAM_TOL})")
    return errs


def large_grid_wrappers(rng, card, dev):
    """The wrappers at m = 4,096 and 16,384 through their entry points, with
    the launch counters zeroed just before and read just after. Returns the
    launches of this path and per-wrapper results."""
    f32 = np.float32

    def points(n):
        x = rng.uniform(-1, 1, (n, 2)).astype(f32)
        return x, np.sin(3 * x[:, :1])

    x0, y0 = points(N_WRAP_SEED)
    xu, yu = points(N_WRAP_UPD)
    xt, _ = points(N_TEST)
    xp, yp = points(N_PREQ6)
    xa, ya = points(N_ABSORB6)
    x_twin = xt[:64]
    configs = (("dense m=4096", dict(grid_size=M6_SIDE), 1),
               ("low_rank=512 m=4096", dict(grid_size=M6_SIDE, low_rank=LR_RANK), 2),
               (f"routed m={BIG_SIDE**2}", dict(grid_size=BIG_SIDE), 2))
    regs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the rank-capped core ignores update_stem, with a warning
        for name, kw, _ in configs:
            regs[name] = OnlineSKIRegression(LinearStem(2, 2), x0, y0, lr=TRAIN_LR, device=dev, **kw)
    if type(regs["dense m=4096"]) is not OnlineSKIRegression or not all(
            isinstance(regs[n], OnlineSKILowRankRegression) for n, _, _ in configs[1:]):
        raise AssertionError("OnlineSKIRegression did not route the large grids as expected")
    torch.cuda.synchronize()

    zero_counters()
    results = {}
    for name, kw, n_twin in configs:
        reg = regs[name]
        twin = load_twin(reg, x0, y0, lr=TRAIN_LR, **kw)
        upd_ms, per_update, losses = [], [], []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i in range(N_WRAP_UPD):
                before = (rank1_apply.launches, blocked_cholesky.launches)
                r0 = time.perf_counter()
                losses.append(reg.update(xu[i : i + 1], yu[i : i + 1]))  # floats: the host waits
                upd_ms.append(1e3 * (time.perf_counter() - r0))
                per_update.append((rank1_apply.launches - before[0], blocked_cholesky.launches - before[1]))
                if i < n_twin:
                    losses.append(twin.update(xu[i : i + 1], yu[i : i + 1]))
                if i == n_twin - 1:
                    twin_errs = _compare_twin_predictions(reg, twin, x_twin, name)
        r0 = time.perf_counter()
        mean, var = reg.predict(xt)
        torch.cuda.synchronize()
        pred_ms = 1e3 * (time.perf_counter() - r0)
        r = dict(m=reg.model.grid.num_points, update_ms_median=float(np.median(upd_ms[1:])),
                 update_ms=upd_ms, predict_ms=pred_ms, K2_K6_per_update=sorted(set(per_update)),
                 twin_updates=n_twin, twin=twin_errs)
        if name == "dense m=4096":
            r0 = time.perf_counter()
            pm, pv = reg.prequential(xp, yp)
            torch.cuda.synchronize()
            r1 = time.perf_counter()
            reg.absorb(xa, ya)
            torch.cuda.synchronize()
            r.update(prequential_ms=1e3 * (r1 - r0), absorb_ms=1e3 * (time.perf_counter() - r1))
            if any(k2 != 1 for k2, _ in per_update):
                raise AssertionError(f"K2 did not launch once per q = 1 update at m = 4,096: {per_update}")
            if any(k6 < 1 for _, k6 in per_update):
                raise AssertionError(f"an update() at m = 4,096 did not factor Q with K6: {per_update}")
            for what, t in (("prequential mean", pm), ("prequential var", pv)):
                if tuple(t.shape) != (N_PREQ6, 1) or not torch.isfinite(t).all():
                    raise AssertionError(f"{name}: {what} is not finite of shape ({N_PREQ6}, 1)")
        values = [v for pair in losses for v in pair]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{name}: a non-finite loss: {values}")
        for what, t in (("mean", mean), ("var", var)):
            if tuple(t.shape) != (N_TEST, 1) or not torch.isfinite(t).all():
                raise AssertionError(f"{name}: predicted {what} is not finite of shape ({N_TEST}, 1)")
        r["rmse"] = float(torch.sqrt(torch.mean((mean[:, 0].cpu() - torch.sin(3 * torch.tensor(xt[:, 0]))) ** 2)))
        results[name] = r
        print(f"wrapper {name} on {card}: " + json.dumps(r))
    launches = read_counters()
    print(f"  phase 6 wrapper path kernel launches: {json.dumps(launches)}")
    for kname in ("rank1_apply", "blocked_chunk", "pred_chunk", "blocked_cholesky"):
        if launches[kname] <= 0:
            raise AssertionError(f"the phase 6 wrapper path never launched {kname}")
    if launches["chunk_recursion_cluster"] or launches["pred_recursion_cluster"]:
        raise AssertionError("a chunk at m = 4,096 ran its recursion on a cluster")
    return launches, results


def large_grid(rng, peaks, card, dev):
    """Phase 6; returns (kernel rows at m = 4,096, launches of its wrapper
    path, results)."""
    t0 = time.perf_counter()
    model, params, state = large_model(dev, rng)
    kernels6 = check_kernels_large(rng, model, params, state, peaks, dev)
    for kname, r in kernels6.items():
        print(f"{kname} m={model.grid.num_points} on {card}: " + json.dumps(r))
    t1 = time.perf_counter()
    results = {"hyper": iterative_hyper_step(model, params, state, card)}
    t2 = time.perf_counter()
    results["stream"] = lowrank_stream(rng, card, dev)
    t3 = time.perf_counter()
    launches6, results["wrappers"] = large_grid_wrappers(rng, card, dev)
    t4 = time.perf_counter()
    print(f"phase 6 command time: {t4 - t0:.1f} s (kernel checks {t1 - t0:.1f}, hyper step {t2 - t1:.1f}, "
          f"rank-capped stream {t3 - t2:.1f}, wrappers {t4 - t3:.1f})")
    return kernels6, launches6, results


# --------------------------------------------------------------------------
# phase 7: Dirichlet classification through OnlineSKIClassifier
# --------------------------------------------------------------------------


def spread(values):
    return dict(median=float(np.median(values)), min=float(np.min(values)), max=float(np.max(values)))


def per_update_launches(clf, x, y, q):
    """clf.update on q-point batches of (x, y): the call times (s), losses and
    (K2, K6) launches of each call."""
    times, losses, launches = [], [], []
    for i in range(0, len(x), q):
        before = (rank1_apply.launches, blocked_cholesky.launches)
        t0 = time.perf_counter()
        losses.append(clf.update(x[i : i + q], y[i : i + q]))  # returns floats: the host waits for the card
        times.append(time.perf_counter() - t0)
        launches.append((rank1_apply.launches - before[0], blocked_cholesky.launches - before[1]))
    return times, losses, launches


def gpd_path(card, dev):
    """Phase 7 (a): the experiment layer's wiski_gpd model (banana, 2
    classes; online_gp_tpu/experiments/config.py:45-46) through the entry
    point, as tests/classification/test_ski_classifier.py::test_online_eye_stem
    runs it, then an absorb of the rest of the training split. The launch
    counters are zeroed just before and read just after. Returns (the
    classifier, launches, results)."""
    tr_x, tr_y, te_x, te_y = banana_dataset(n=GPD_N, seed=0)
    clf = OnlineSKIClassifier(IdentityStem(2), tr_x[:GPD_INIT], tr_y[:GPD_INIT], alpha_eps=CLS_ALPHA_EPS,
                              lr=GPD_LR, grid_size=GPD_SIDE, grid_bound=1.0, device=dev)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    clf.fit(tr_x[:GPD_INIT], tr_y[:GPD_INIT], num_epochs=GPD_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    clf.set_lr(GPD_STREAM_LR)
    correct, upd_s, pred_s, per_update = 0, [], [], []
    for i in range(GPD_INIT, GPD_INIT + GPD_STREAM):
        t0 = time.perf_counter()
        pred = clf.predict(tr_x[i : i + 1])
        correct += int(pred[0] == int(tr_y[i]))  # the host waits for the card
        pred_s.append(time.perf_counter() - t0)
        times, _, launches = per_update_launches(clf, tr_x[i : i + 1], tr_y[i : i + 1], 1)
        upd_s += times
        per_update += launches
    cum_acc = correct / GPD_STREAM
    test_acc = clf.evaluate(te_x, te_y)
    rest = slice(GPD_INIT + GPD_STREAM, len(tr_x))
    t0 = time.perf_counter()
    clf.absorb(tr_x[rest], tr_y[rest])
    torch.cuda.synchronize()
    absorb_s = time.perf_counter() - t0
    launches = read_counters()
    r = dict(m=clf.model.grid.num_points, classes=clf.num_classes, fit_s=fit_s, cumulative_acc=cum_acc,
             test_acc=test_acc, test_acc_after_absorb=clf.evaluate(te_x, te_y),
             update_ms=spread([1e3 * t for t in upd_s[1:]]), predict_one_ms=spread([1e3 * t for t in pred_s[1:]]),
             absorb_points=len(tr_x[rest]), absorb_points_per_s=len(tr_x[rest]) / absorb_s,
             K2_K6_per_update=sorted(set(per_update)), launches=launches)
    print(f"phase 7 (a) wiski_gpd (IdentityStem, m={GPD_SIDE**2}, C=2) on {card}: " + json.dumps(r))
    if not (cum_acc >= GPD_CUM_GATE and test_acc >= GPD_TEST_GATE):
        raise AssertionError(f"wiski_gpd: cumulative accuracy {cum_acc:.4f} (gate {GPD_CUM_GATE}), "
                             f"test accuracy {test_acc:.4f} (gate {GPD_TEST_GATE})")
    check_classifier_launches(launches, per_update, "wiski_gpd")
    return clf, launches, r


def check_classifier_launches(launches, per_update, what):
    """K2 once per q = 1 update, K6 on every update, K1 in absorb with its
    recursion on a cluster."""
    if any(k2 != 1 for k2, _ in per_update):
        raise AssertionError(f"{what}: K2 did not launch once per q = 1 update: {sorted(set(per_update))}")
    if any(k6 < 1 for _, k6 in per_update):
        raise AssertionError(f"{what}: an update() did not factor Q with K6: {sorted(set(per_update))}")
    if launches["blocked_chunk"] < 1 or launches["chunk_recursion_cluster"] != launches["blocked_chunk"]:
        raise AssertionError(f"{what}: absorb did not run K1 on its cluster recursion: {launches}")


def classifier_path(card, dev):
    """Phase 7 (b): OnlineSKIClassifier at the constructor's default width
    (LinearStem(2, 2), grid 30, m = 900, C = 2) on banana points: 64
    update()s at q = 1, 8 at q = 32, a predict of 1,024 and an absorb of
    4,096, with the launch counters zeroed just before and read just after.
    A CPU twin (convert) runs the first 8 updates: params within
    TWIN_PARAM_TOL, roots within 1e-3 * scale. Returns (the classifier,
    launches, results, the test split)."""
    tr_x, tr_y, te_x, te_y = banana_dataset(n=CLS_N, seed=1)
    n0, n8 = CLS_SEED_PTS, CLS_SEED_PTS + CLS_TWIN
    n1, n32 = n0 + CLS_UPD1, n0 + CLS_UPD1 + 32 * CLS_UPD32
    kw = dict(alpha_eps=CLS_ALPHA_EPS, lr=TRAIN_LR, grid_size=M_SIDE)
    clf = OnlineSKIClassifier(LinearStem(2, 2), tr_x[:n0], tr_y[:n0], device=dev, **kw)
    twin = load_twin(clf, tr_x[:n0], tr_y[:n0], cls=OnlineSKIClassifier, **kw)
    torch.cuda.synchronize()
    zero_counters()
    t1, losses, per_update = per_update_launches(clf, tr_x[n0:n8], tr_y[n0:n8], 1)
    for i in range(n0, n8):
        losses.append(twin.update(tr_x[i : i + 1], tr_y[i : i + 1]))
    twin_errs = compare_twin(clf, twin)
    more = per_update_launches(clf, tr_x[n8:n1], tr_y[n8:n1], 1)
    t1, losses, per_update = t1 + more[0], losses + more[1], per_update + more[2]
    t32, losses32, per32 = per_update_launches(clf, tr_x[n1:n32], tr_y[n1:n32], 32)
    xt = te_x[:CLS_PRED]
    pred_ms = []
    for _ in range(HOST_REPEATS + 1):
        t0 = time.perf_counter()
        pred = clf.predict(xt)
        torch.cuda.synchronize()
        pred_ms.append(1e3 * (time.perf_counter() - t0))
    xa, ya = tr_x[n32 : n32 + CLS_ABSORB], tr_y[n32 : n32 + CLS_ABSORB]
    t0 = time.perf_counter()
    clf.absorb(xa, ya)
    torch.cuda.synchronize()
    absorb_s = time.perf_counter() - t0
    launches = read_counters()
    r = dict(m=clf.model.grid.num_points, classes=clf.num_classes,
             update_q1_ms=spread([1e3 * t for t in t1[1:]]),
             update_q32_points_per_s=spread([32 / t for t in t32[1:]]), predict_ms=spread(pred_ms[1:]),
             predict_points=len(xt), absorb_points=len(xa), absorb_points_per_s=len(xa) / absorb_s,
             test_acc=clf.evaluate(te_x, te_y), K2_K6_per_update=sorted(set(per_update)),
             K6_per_q32_update=sorted({k6 for _, k6 in per32}), twin=twin_errs, launches=launches)
    print(f"phase 7 (b) OnlineSKIClassifier (LinearStem(2, 2), m={M_SIDE**2}, C=2) on {card}: " + json.dumps(r))
    values = [v for pair in losses + losses32 for v in pair]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"classifier path: a non-finite loss: {values}")
    if tuple(pred.shape) != (CLS_PRED,) or not bool(((pred == 0) | (pred == 1)).all()):
        raise AssertionError("classifier path: predict did not return one class label per point")
    check_classifier_launches(launches, per_update, "classifier path")
    if any(k6 < 1 for _, k6 in per32):
        raise AssertionError("classifier path: a q = 32 update() did not factor Q with K6")
    return clf, launches, r, (te_x, te_y)


def lowrank_classifier_path(card, dev):
    """Phase 7 (c): the rank-capped classifier at grid 72 (m = 5,184, routed)
    with low_rank=256, as tests/classification/test_lowrank_classifier.py::
    test_big_grid_auto_routes_and_learns_banana runs it."""
    tr_x, tr_y, te_x, te_y = banana_dataset(seed=0)
    w = OnlineSKIClassifier(IdentityStem(2), tr_x[:LRC_INIT], tr_y[:LRC_INIT], grid_size=LRC_SIDE, lr=GPD_LR,
                            low_rank=LRC_RANK, device=dev)
    if not isinstance(w, OnlineSKILowRankClassifier):
        raise AssertionError("OnlineSKIClassifier did not route grid 72 to the rank-capped core")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.fit(tr_x[:LRC_INIT], tr_y[:LRC_INIT], num_epochs=LRC_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    upd_ms = []
    for i in range(LRC_INIT, LRC_INIT + 4 * LRC_UPDATES, 4):
        t0 = time.perf_counter()
        w.update(tr_x[i : i + 4], tr_y[i : i + 4], update_stem=False)
        upd_ms.append(1e3 * (time.perf_counter() - t0))
    acc = w.evaluate(te_x, te_y)
    r = dict(m=w.model.grid.num_points, rank=w.model.rank, fit_s=fit_s, update_q4_ms=spread(upd_ms[1:]),
             test_acc=acc)
    print(f"phase 7 (c) OnlineSKILowRankClassifier on {card}: " + json.dumps(r))
    if not (math.isfinite(acc) and acc >= LRC_GATE):
        raise AssertionError(f"rank-capped classifier: banana accuracy {acc:.4f} (gate {LRC_GATE})")
    return r


def _state_fields(state):
    return {"wty": state.wty, "ydy": state.ydy, "d_logdet": state.d_logdet, "mat": state.roots.mat,
            "root": state.roots.root, "inv_root": state.roots.inv_root}


def _state_to(state, device):
    return state._replace(wty=state.wty.to(device), ydy=state.ydy.to(device), d_logdet=state.d_logdet.to(device),
                          roots=RootCache(*(None if t is None else t.to(device) for t in state.roots)))


def differentiable_route(clf, te_x, te_y, card):
    """Phase 7 (d): wiski_fantasize (F = 3, q = 2) and the differentiable
    route (detach_interp=False: condition at q = 1 and 2, a stream and a
    prequential stream of 16 in chunks of 8), with gradients with respect
    to x, on the classifier's CUDA state, each against a CPU twin of the
    same call (values within 1e-3 * scale, gradients within HYPER_GRAD_RTOL
    of their largest entry). K1, K2 and K3 must not launch, and the base
    state must come back bitwise as it was."""
    model, state = clf.model, clf.state
    grid = model.grid
    host_model = model._replace(grid=convert.grid_from_numpy(
        grid.sizes, grid.mins.cpu().numpy(), grid.spacings.cpu().numpy(), device="cpu"))
    host_state = _state_to(state, "cpu")
    params = {"kernel": {k: v.detach() for k, v in clf.params["kernel"].items()}}
    host_params = {"kernel": {k: v.cpu() for k, v in params["kernel"].items()}}
    snapshot = {k: None if v is None else v.clone() for k, v in _state_fields(state).items()}
    feats = clf._features(clf._inputs(te_x[:16]))
    targets, sigma2 = clf._transform(te_y[:16])
    with torch.no_grad():
        caches = wiski_prediction_caches(model, params, state)
    host_caches = tuple(c.cpu() for c in caches)
    rng = np.random.default_rng(SEED + 7)
    weights = {k: torch.tensor(rng.normal(size=tuple(v.shape)) / v.numel() ** 0.5, dtype=torch.float32)
               for k, v in _state_fields(state).items() if k in ("wty", "mat", "root", "inv_root")}

    def scalar(st):
        fields = _state_fields(st)
        return sum(torch.sum(fields[k] * w.to(fields[k].device)) for k, w in weights.items())

    def cases(mdl, prm, st, c):
        y, n = targets.to(st.wty.device), sigma2.to(st.wty.device)
        return {
            "condition q=1": lambda x: scalar(wiski_condition(mdl, st, x[:1], y[:1], n[:1], detach_interp=False)),
            "condition q=2": lambda x: scalar(wiski_condition(mdl, st, x[:2], y[:2], n[:2], detach_interp=False)),
            "stream 16": lambda x: scalar(wiski_stream(mdl, st, x, y, n, detach_interp=False, block_size=8)),
            "prequential 16": lambda x: (lambda o: scalar(o[0]) + o[2].sum() + o[3].sum())(
                wiski_prequential_stream(mdl, prm, st, c, x, y, n, detach_interp=False, block_size=8)),
        }

    before = (rank1_apply.launches, blocked_chunk.launches, pred_chunk.launches)
    fx = feats[: N_FANT * Q_FANT].reshape(N_FANT, Q_FANT, 2)
    fy = targets[: N_FANT * Q_FANT].reshape(N_FANT, Q_FANT, -1)
    fn = sigma2[: N_FANT * Q_FANT].reshape(N_FANT, Q_FANT, -1)
    fant = wiski_fantasize(model, state, fx, fy, fn)
    host_fant = wiski_fantasize(host_model, host_state, fx.cpu(), fy.cpu(), fn.cpu())
    out = {}
    for name, got in _state_fields(fant).items():
        want = _state_fields(host_fant)[name]
        err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
        out[f"fantasize {name}"] = err
        if got.shape != (N_FANT, *snapshot[name].shape) or not err <= 1e-3 * max(scale, 1.0):
            raise AssertionError(f"wiski_fantasize {name}: {tuple(got.shape)}, differs from the CPU twin by {err:.3e}")
    card_cases, host_cases = cases(model, params, state, caches), cases(host_model, host_params, host_state,
                                                                        host_caches)
    for name, fn_card in card_cases.items():
        grads = []
        for fn_, x in ((fn_card, feats), (host_cases[name], feats.cpu())):
            x = x.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(fn_(x), [x])
            grads.append(g)
        err, scale = float((grads[0].cpu() - grads[1]).abs().max()), float(grads[1].abs().max())
        out[f"d/dx {name}"] = err / scale
        if not (bool(torch.isfinite(grads[0]).all()) and err <= HYPER_GRAD_RTOL * scale):
            raise AssertionError(f"d/dx of {name} (detach_interp=False) on the card: {err:.3e} from the CPU twin "
                                 f"(largest entry {scale:.3e})")
    torch.cuda.synchronize()
    moved = (rank1_apply.launches - before[0], blocked_chunk.launches - before[1], pred_chunk.launches - before[2])
    if moved != (0, 0, 0):
        raise AssertionError(f"the differentiable route launched (K2, K1, K3) {moved} times")
    for name, was in snapshot.items():
        now = _state_fields(state)[name]
        if (was is None) != (now is None) or (was is not None and not torch.equal(was, now)):
            raise AssertionError(f"the differentiable route moved the base state's {name}")
    print(f"phase 7 (d) fantasize and the differentiable route on {card}: " + json.dumps(out))
    return out


def check_kernels_cls(clfs, peaks, card):
    """Phase 7 (e): K2 (16 calls), K1 (one chunk of k = 128, on its cluster
    recursion) and K6 (Q) at Bd = C = 2 on the classifiers' states at m = 256
    and m = 900, against their plain versions at phase 2's and phase 4's
    tolerances, with device times, bounds and yardsticks. The update vectors
    are banana points' stencils over sqrt(sigma2), each class its noise."""
    out = {}
    tr_x, tr_y, _, _ = banana_dataset(n=CLS_N, seed=2)
    for tag, clf in clfs.items():
        grid, state = clf.model.grid, clf.state
        m = grid.num_points
        L, B = state.roots.root.contiguous(), state.roots.inv_root.contiguous()
        feats = clf._features(clf._inputs(tr_x[:K]))
        _, sigma2 = clf._transform(tr_y[:K])
        idx, w = interp_coeffs(grid, feats)
        idx = idx.to(torch.int32).contiguous()
        wv = (w[None] / torch.sqrt(sigma2.T)[:, :, None]).contiguous()  # (C, K, P)
        rows = {"rank1_apply": check_k2(L, B, idx[:N_K2_6], wv[:, :N_K2_6], peaks, f"{tag} Bd=2")}
        if chunk_cluster_plan(K, m) is None:
            raise AssertionError(f"(k={K}, m={m}) was expected inside K1's cluster envelope")
        rows["blocked_chunk"] = check_k1(L, B, idx, wv, peaks, f"{tag} Bd=2", True)
        rows["blocked_cholesky"] = check_k6(q_matrix(clf.model, clf.params, state), peaks, f"Q ({tag}, Bd=2)")
        for kname, r in rows.items():
            out[f"{kname}@{tag}-bd2"] = r
            print(f"{kname} {tag} Bd=2 on {card}: " + json.dumps(r))
    return out


def classification(peaks, card, dev):
    """Phase 7; returns (kernel rows, {row: launches}, the launch counts of
    the windows of (a) and (b))."""
    t0 = time.perf_counter()
    clf_a, launches_a, _ = gpd_path(card, dev)
    clf_b, launches_b, _, (te_x, te_y) = classifier_path(card, dev)
    lowrank_classifier_path(card, dev)
    differentiable_route(clf_b, te_x, te_y, card)
    rows = check_kernels_cls({"cls-m256": clf_a, "cls-m900": clf_b}, peaks, card)
    launches = {row: (launches_a if "m256" in row else launches_b)[row.split("@")[0]] for row in rows}
    print(f"phase 7 command time: {time.perf_counter() - t0:.1f} s")
    return rows, launches, (launches_a, launches_b)


# --------------------------------------------------------------------------
# phase 8: the online baselines at the experiment presets' widths
# --------------------------------------------------------------------------


def _host_tree(tree):
    """A nested dict (or NamedTuple fields) of tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _copy_optimizers(src, dst):
    """The Adam moments and step counts of src's optimizers into dst's (the
    loaders of convert start them fresh; the wrappers carry them across
    fit and updates)."""
    for name in ("opt", "stem_opt"):
        a, b = getattr(src, name, None), getattr(dst, name, None)
        if a is not None and a.opt is not None:
            b.opt.load_state_dict(copy.deepcopy(a.opt.state_dict()))  # no state shared with src
            b.count = a.count


def _cast_tree(tree, dtype):
    """Floating numpy arrays of a nested dict in ``dtype`` (None: as they are)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if dtype is not None and isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
        return tree.astype(dtype)
    return tree


def baseline_twin(w, cls, x0, y0, kw, dtype=None):
    """A CPU twin of the baseline wrapper w, built with its configuration kw
    and started from w's state as it stands through convert's loaders,
    optimizer moments copied; ``dtype`` casts its params and state (the
    local GP's expert buffers stay float32, as the JAX package keeps them)."""
    twin = cls(IdentityStem(x0.shape[1]), x0, y0, device="cpu", **kw)
    host = lambda tree: _cast_tree(_host_tree(tree), dtype)
    params = host(w.params)
    if isinstance(w, (OnlineExactRegression, OnlineExactClassifier)):
        convert.load_exact(twin, params, {}, {}, host(w.data._asdict()), host(w._raw), device="cpu")
    elif isinstance(w, OnlineLocalGPRegression):
        convert.load_localgp(twin, params, {}, {}, _host_tree(w.state._asdict()), device="cpu")
    elif isinstance(w, OnlineSGPRegression):
        convert.load_sgpr(twin, params, {}, {}, None if w.old is None else host(w.old._asdict()),
                          None if w.moments is None else host(w.moments._asdict()), w._absorbs_since_rebase,
                          device="cpu")
    else:
        convert.load_svgp(twin, params, {}, {}, None if w.old is None else host(w.old._asdict()), device="cpu")
    _copy_optimizers(w, twin)
    return twin


def compare_baseline_twin(w, twin, make_ref, xt, what):
    """w (the card, float32) against its CPU float32 twin: every param leaf
    within 1e-3 of max(|.|, 1), the predictions on xt within 1e-3 of their
    scale, predicted labels the same but where p(y = 1) lies within that
    difference of 0.5 (at least 99% of them, where a classifier gives
    labels alone). Where a bound is missed, ``make_ref()`` runs the
    float64 twin, and twice the CPU's own float32 distance from float64 is
    added to the bound: the card's and the CPU's float32 errors are two
    independent errors of about that size (float32's resolution through an
    ill-conditioned K_zz, and Adam's steps on gradient entries at rounding
    level, which it normalizes to full size)."""
    xt64 = xt.astype(np.float64)
    leaves = lambda m: [(n, t.detach().cpu().double()) for n, t in _named_leaves(m.params)]

    def outs(m, x):
        out = m.predict(x)
        return [o.cpu() for o in (out if isinstance(out, tuple) else (out,))]

    # (name, card, CPU float32, scale, the float64 twin's value or None)
    pairs = [(n, a, b, max(float(b.abs().max()), 1.0), i) for i, ((n, a), (_, b)) in
             enumerate(zip(leaves(w), leaves(twin)))]
    out_w, out_t = outs(w, xt), outs(twin, xt)
    floats = [(f"predict {i}", a.double(), b.double(), max(float(b.abs().max()), 1e-30), i)
              for i, (a, b) in enumerate(zip(out_w, out_t)) if a.is_floating_point()]
    ref = None
    errs = {}
    for kind, rows in (("param", pairs), ("prediction", floats)):
        for name, a, b, scale, i in rows:
            err = float((a - b).abs().max())
            errs[name] = [err]
            if err <= BASE_TWIN_RTOL * scale:
                continue
            if ref is None:
                ref = make_ref()
                ref_leaves, ref_out = leaves(ref), outs(ref, xt64)
            c = ref_leaves[i][1] if kind == "param" else ref_out[i].double()
            ref_err = float((b - c).abs().max())
            errs[name].append(ref_err)
            if not (torch.isfinite(a).all() and err <= BASE_TWIN_RTOL * scale + 2.0 * ref_err):
                raise AssertionError(f"{what} CPU twin: {kind} {name} differs by {err:.3e} (scale {scale:.3e}; "
                                     f"float32 vs float64 on the CPU: {ref_err:.3e})")
    if not out_w[0].is_floating_point():
        differ = out_w[0] != out_t[0]
        errs["label mismatch share"] = float(differ.double().mean())
        if floats:
            # a label may flip only where p(y = 1) is within the measured p
            # difference of the 0.5 threshold
            p_err, p_twin = errs[floats[-1][0]][0], floats[-1][2]
            bad = differ & ((p_twin - 0.5).abs() > p_err)
            if bool(bad.any()):
                raise AssertionError(f"{what} CPU twin: {int(bad.sum())} labels differ away from p = 0.5")
        elif not errs["label mismatch share"] <= 0.01:
            raise AssertionError(f"{what} CPU twin: {errs['label mismatch share']:.3%} of the predicted labels differ")
    return errs


def profile_baseline_update(w, x, y, card, what):
    """One update() under torch.profiler after a warm-up: wall ms, CUDA
    kernel ms and launches, the device's idle share, and the host syncs
    (readbacks of a device scalar, aten::_local_scalar_dense, and
    device-to-host copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    w.update(x[:1], y[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        w.update(x[1:2], y[1:2])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, launches, dtoh, scalars = 0.0, 0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            if "Memcpy DtoH" in e.name:
                dtoh += 1
            else:
                launches += 1
                busy_us += e.time_range.end - e.time_range.start
        elif e.name == "aten::_local_scalar_dense":
            scalars += 1
    r = dict(wall_ms=wall_us / 1e3, cuda_kernel_ms=busy_us / 1e3, launches=launches,
             device_idle_share=1 - busy_us / wall_us, scalar_readbacks=scalars, dtoh_copies=dtoh)
    print(f"  {what} update() under torch.profiler on {card}: " + json.dumps(r))
    return r


def baseline_stream(name, card, dev):
    """One preset (online_gp_tpu/experiments/config.py:24-50) on the card
    with an IdentityStem, as experiments/regression.py runs it: init on the
    first 5% of the training stream, a fit of BASE_FIT_EPOCHS on it, then
    BASE_STREAM prequential steps at batch 1 (evaluate the point, then
    update), then the test set. CPU twins (convert) at float32 and at
    float64 run BASE_TWIN steps from the state after the first update (see
    compare_baseline_twin). Returns the results."""
    cls, task, kw = BASE_PRESETS[name]
    if task == "regression":
        tr_x, tr_y, te_x, te_y = streaming_friedman(n=BASE_N, num_dims=BASE_DIMS, seed=0)
    else:
        tr_x, tr_y, te_x, te_y = banana_dataset(n=BASE_CLS_N, seed=0)
    n0 = int(BASE_INIT_RATIO * len(tr_x))
    x0, y0 = tr_x[:n0], tr_y[:n0]
    w = cls(IdentityStem(tr_x.shape[1]), x0, y0, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.fit(x0, y0, BASE_FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    upd_ms, losses, online, twin_errs, twin_s = [], [], [], None, 0.0
    t_stream = time.perf_counter()
    for i in range(n0, n0 + BASE_STREAM):
        x, y = tr_x[i : i + 1], tr_y[i : i + 1]
        if i == n0 + 1:
            # the twins start after the first update: the fit leaves the
            # optimizers fresh, and a fresh Adam's first step is lr * sign(g),
            # which turns a gradient entry at float32 rounding level (K_zz's
            # condition reaches 4e10 at 256 inducing points in 2-D) into a
            # full step of either sign
            twin, ref = baseline_twin(w, cls, x0, y0, kw), baseline_twin(w, cls, x0, y0, kw, np.float64)
            twin_steps = []
        if task == "regression":
            online.append(w.evaluate(x, y)[0])
        else:
            pred = w.predict(x)
            pred = pred[0] if isinstance(pred, tuple) else pred
            online.append(float(int(pred[0]) == int(y[0])))
        t1 = time.perf_counter()
        losses.append(w.update(x, y))  # returns floats: the host waits for the card
        upd_ms.append(1e3 * (time.perf_counter() - t1))
        if 1 <= i - n0 <= BASE_TWIN:
            t1 = time.perf_counter()
            losses.append(twin.update(x, y))
            twin_steps.append((x.astype(np.float64), y.astype(np.float64) if task == "regression" else y))
            if i - n0 == BASE_TWIN:

                def make_ref():
                    for step in twin_steps:
                        ref.update(*step)
                    return ref

                twin_errs = compare_baseline_twin(w, twin, make_ref, te_x, name)
            twin_s += time.perf_counter() - t1
    pred_ms = []
    for _ in range(HOST_REPEATS + 1):
        t1 = time.perf_counter()
        out = w.predict(te_x)
        torch.cuda.synchronize()
        pred_ms.append(1e3 * (time.perf_counter() - t1))
    stream_s = time.perf_counter() - t_stream - twin_s
    r = dict(preset=name, n_init=n0, fit_epochs=BASE_FIT_EPOCHS, fit_ms=fit_ms, stream=BASE_STREAM,
             stream_s=stream_s, cpu_twins_s=twin_s,
             update_ms=spread(upd_ms[1:]), predict_ms=spread(pred_ms[1:]), predict_points=len(te_x))
    if task == "regression":
        r["online_rmse"] = float(np.mean(online))
        r["test_rmse"], r["test_nll"] = w.evaluate(te_x, te_y)
        mean, var = out
        values = [mean, var]
    else:
        r["online_acc"] = float(np.mean(online))
        r["test_acc"] = w.evaluate(te_x, te_y)
        values = [out[1]] if isinstance(out, tuple) else []
    r["twin"] = twin_errs
    flat = [v for pair in losses for v in pair if not (isinstance(w, OnlineSGPRegression) and math.isnan(v))]
    if not all(math.isfinite(v) for v in flat):
        raise AssertionError(f"{name}: a non-finite loss on the stream")
    for t in values:
        if t.shape[0] != len(te_x) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: the test predictions are not finite of {len(te_x)} rows")
    if task == "regression" and not all(math.isfinite(r[k]) for k in ("test_rmse", "test_nll")):
        raise AssertionError(f"{name}: test RMSE or NLL not finite")
    print(f"phase 8 {name} ({cls.__name__}, IdentityStem({tr_x.shape[1]})) on {card}: " + json.dumps(r))
    r["profile"] = profile_baseline_update(w, tr_x[n0 + BASE_STREAM :], tr_y[n0 + BASE_STREAM :], card, name)
    return r


def baseline_bars(card, dev):
    """The JAX package's own quality bars (tests/regression/test_baseline_models.py:33-138)
    on the card, at their configurations: IdentityStem(2),
    streaming_friedman(n=1200, num_dims=2) and banana_dataset(n=800)."""
    t0 = time.perf_counter()
    tx, ty, ex, ey = streaming_friedman(n=1200, num_dims=2, seed=0)
    bx, by, bex, bey = banana_dataset(n=800, seed=0)
    s2, res = IdentityStem, {}

    m = OnlineExactRegression(s2(2), tx[:100], ty[:100], lr=0.05, device=dev)
    m.fit(tx[:400], ty[:400], num_epochs=40)
    fit_rmse, fit_nll = m.evaluate(ex, ey)
    for i in range(400, 420):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["exact_regression"] = r = dict(rmse=fit_rmse, nll=fit_nll, rmse_after_stream=m.evaluate(ex, ey)[0])
    ok = r["rmse"] <= 0.2 and r["nll"] <= 1.0 and r["rmse_after_stream"] <= 0.2

    m = OnlineSVGPRegression(s2(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, streaming=True, device=dev)
    m.fit(tx[:800], ty[:800], num_epochs=150, batch_size=256)
    rmse = m.evaluate(ex, ey)[0]
    for i in range(800, 820):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["svgp_regression"] = r = dict(rmse=rmse, rmse_after_stream=m.evaluate(ex, ey)[0])
    ok &= r["rmse"] <= 0.6 and math.isfinite(r["rmse_after_stream"])

    arms = {}
    for mode in ("closed_form", "grad"):
        m = OnlineSVGPRegression(s2(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, streaming=True,
                                 variational_mode=mode, device=dev)
        m.fit(tx[:100], ty[:100], num_epochs=60, batch_size=100)
        for i in range(100, 500, 4):
            m.update(tx[i : i + 4], ty[i : i + 4])
        arms[mode] = m.evaluate(ex, ey)[0]
    res["svgp_closed_form_streaming"] = arms
    ok &= math.isfinite(arms["closed_form"]) and arms["closed_form"] <= arms["grad"] + 1e-6 and arms["closed_form"] <= 0.45

    m = OnlineSGPRegression(s2(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, num_update_steps=0, device=dev)
    m.fit(tx[:800], ty[:800], num_epochs=60)
    rmse = m.evaluate(ex, ey)[0]
    for i in range(800, 900):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["sgpr_regression"] = r = dict(rmse=rmse, rmse_after_stream=m.evaluate(ex, ey)[0])
    ok &= r["rmse"] <= 0.3 and r["rmse_after_stream"] <= r["rmse"] + 0.05

    m = OnlineLocalGPRegression(s2(2), tx[:200], ty[:200], lr=0.05, max_data_per_model=128, max_experts=8, device=dev)
    m.fit(tx[:200], ty[:200], num_epochs=40)
    for i in range(200, 260):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["localgp_regression"] = r = dict(rmse=m.evaluate(ex, ey)[0], experts=m.num_experts)
    ok &= r["rmse"] <= 0.35 and r["experts"] >= 2

    c = OnlineExactClassifier(s2(2), bx[:100], by[:100], lr=0.05, device=dev)
    c.fit(bx[:400], by[:400], num_epochs=40)
    acc = c.evaluate(bex, bey)
    correct = 0
    for i in range(400, 500):
        correct += int(int(c.predict(bx[i : i + 1])[0]) == by[i])
        c.update(bx[i : i + 1], by[i : i + 1])
    res["exact_classifier"] = r = dict(test_acc=acc, online_acc=correct / 100, test_acc_after_stream=c.evaluate(bex, bey))
    ok &= r["test_acc"] >= 0.89 and r["online_acc"] >= 0.80 and r["test_acc_after_stream"] >= 0.89

    v = OnlineSVGPClassifier(s2(2), bx[:100], by[:100], num_inducing=32, lr=0.1, device=dev)
    v.fit(bx[:600], by[:600], num_epochs=150, batch_size=256)
    acc = v.evaluate(bex, bey)
    correct = 0
    for i in range(600, 640):
        correct += int(int(v.predict(bx[i : i + 1])[0][0]) == by[i])
        v.update(bx[i : i + 1], by[i : i + 1])
    res["svgp_classifier"] = r = dict(test_acc=acc, online_acc=correct / 40, test_acc_after_stream=v.evaluate(bex, bey))
    ok &= r["test_acc"] >= 0.85 and r["online_acc"] >= 0.65 and r["test_acc_after_stream"] >= 0.75

    res["seconds"] = time.perf_counter() - t0
    print(f"phase 8 quality bars (tests/regression/test_baseline_models.py) on {card}: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"phase 8: a baseline quality bar failed: {res}")
    return res


def baselines(card, dev):
    """Phase 8: the six baseline wrappers; no kernel of the port runs here
    (the JAX baselines reach no pl.pallas_call), so the launch counters
    must not move."""
    t0 = time.perf_counter()
    zero_counters()
    results = {name: baseline_stream(name, card, dev) for name in BASE_PRESETS}
    results["bars"] = baseline_bars(card, dev)
    launches = read_counters()
    if any(launches.values()):
        raise AssertionError(f"phase 8 launched a WISKI kernel: {launches}")
    print(f"phase 8 command time: {time.perf_counter() - t0:.1f} s")
    return results


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
        results = {"rank1_apply": check_rank1(rng, grid, peaks, dev)}
        results["blocked_chunk"], results["chunk_recursion_cluster"] = check_blocked_chunk(rng, grid, peaks, dev)
        results["pred_chunk"], results["pred_recursion_cluster"] = check_pred_chunk(
            rng, grid, model, params, peaks, dev)
        for kname, by_bd in results.items():
            for Bd, r in by_bd.items():
                case = f"Bd={Bd} m={grid.num_points} k={K}" if isinstance(Bd, int) else f"{Bd} the cluster envelope"
                print(f"{kname} {case} on {card}: " + json.dumps(r))
        profile_condition(rng, model, dev)

        launches, final_state = main_path(rng, model, params, card, dev)

        launches4, Q = remaining_path(rng, model, params, final_state, card, dev)
        for kname, count in launches4.items():
            launches[kname] = launches.get(kname, 0) + count
        results4 = {
            "rank1_update": check_rank1_update(rng, grid, peaks, dev),
            **check_chunk_variants(rng, grid, peaks, dev),
            "blocked_cholesky": check_cholesky(rng, Q, peaks, dev),
        }
        for kname, by_case in results4.items():
            for case, r in by_case.items():
                print(f"{kname} {case if isinstance(case, str) else f'Bd={case}'} m={grid.num_points} on {card}: " + json.dumps(r))
        results.update(results4)

        reg, launches5, (x0, y0), (params5, state5) = training_path(rng, card, dev)
        check_k6_flag(reg.model, params5, state5, card)
        results["hyper_step"] = check_hyper_gradient(reg.model, params5, state5, card)
        time_fit_epochs(reg, x0, y0, card)
        profile_update(reg, rng, card)
        for kname, count in launches5.items():
            launches[kname] += count

        kernels6, launches6, _ = large_grid(rng, peaks, card, dev)
        for kname, count in launches6.items():
            launches[kname] += count

        kernels7, launches7, windows7 = classification(peaks, card, dev)
        for window in windows7:
            for kname, count in window.items():
                launches[kname] += count

        baselines(card, dev)

    meta = {
        "rank1_apply": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:264"),
        "blocked_chunk": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
        "pred_chunk": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
        "chunk_recursion_cluster": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
        "pred_recursion_cluster": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
        "rank1_update": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:298"),
        "blocked_chunk_sub": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:415"),
        "blocked_chunk_coord": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:516"),
        "blocked_cholesky": ("online_gp_torch/csrc/chol.cu", "online_gp_tpu/ops/pallas_chol.py:106"),
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
    rows = [(f"{kname}@m4096", r, launches6[kname]) for kname, r in kernels6.items()]
    rows += [(row, r, launches7[row]) for row, r in kernels7.items()]
    for row, r, count in rows:
        source, replaces = meta[row.split("@")[0]]
        kernels.append({
            "name": row, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
