"""Probe of the costs the K1/K3 cluster recursions are built from, on one
NVIDIA GPU of compute capability 9.0:

    python3 cluster_probe.py [--out FILE]

(a) The round trip of a cluster barrier (`cluster.sync()`, and the split
    `barrier.cluster.arrive.release` / `wait.acquire`) against
    `__syncthreads()`, at cluster sizes 1 to 16 and 512 or 1,024 threads
    a block, with `cudaOccupancyMaxActiveClusters` for each size.
(c) The latency of one dependent chain of loads: local shared memory,
    DSMEM (another block's shared memory in the cluster), and L2.
(b) The stage split of the recursion kernels of online_gp_torch/csrc at
    m = 900, k = 128, Bd = 1, a 2-D cubic stencil (P = 16) on a 30 x 30
    grid: the cluster kernels of K1 (`chunk_recursion_carried_kernel`),
    K5 sub (sub = 32) and K3 (`chunk_sub_cluster_kernel`, with its
    sub-block boundaries' corrections and collapses,
    `pred_recursion_cluster_kernel`; block 0 of the cluster) and K5 coord's
    one-block recursion (`coord_recursion_kernel`), launched through their
    C entries (`ogp_blocked_chunk`, `ogp_blocked_chunk_sub_cluster`,
    `ogp_blocked_chunk_coord`, `ogp_pred_chunk`); K1's one-cluster
    kernel also at m = 256 (a 16 x 16 grid); and at m = 4,096 (a
    64 x 64 grid) K1's recursion on G = 4 clusters of 8 (the plan's) and on
    G = 8 (`chunk_recursion_grid_kernel`, G forced through the C entry),
    with the two cross-cluster sums of a step (GridExchange: block 0's
    wait for the G clusters' sums, from the rank-order sum to stamp 10 or
    11), and K3's on one cluster of 16 blocks. Each
    source is built as it stands with OGP_STAMPS defined (see
    csrc/common.cuh), so that the kernels write clock64() at their stage
    boundaries: each stage's time at steps t = 32, 64 and 127, and summed
    over the chunk, in ns at the SM clock of probe (a) (its cycles over
    its %globaltimer ns).
(d) One cross-block sum of 64 values a block in a cluster of 8 (and 16),
    repeated: through ogp::Exchange of online_gp_torch/csrc/common.cuh
    (st.async into every block's buffer, an mbarrier wait), against a
    cluster barrier followed by DSMEM reads of every block's partials.
(e) The SASS a cluster barrier compiles to (cuobjdump): the instructions
    around its arrive.

It builds its own CUDA sources with nvcc into build/ (including the
port's common.cuh, root_update.cu and pred_stream.cu) and prints one JSON
object (also written to FILE with --out).
"""

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from online_gp_torch.ops import _build
from online_gp_torch.ops.cuda_pred_stream import pred_apply_plan
from online_gp_torch.ops.cuda_root_update import chunk_apply_plan

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// mode 0: cluster.sync(); 1: split arrive.release / wait.acquire; 2: __syncthreads
__global__ void barrier_probe(int mode, int iters, unsigned long long* out) {
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();
  cluster.sync();
  long long c0 = clock64();
  unsigned long long g0 = gtimer();
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) {
      cluster.sync();
    } else if (mode == 1) {
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    } else {
      __syncthreads();
    }
  }
  long long c1 = clock64();
  unsigned long long g1 = gtimer();
  if (threadIdx.x == 0 && cluster.block_rank() == 0 && blockIdx.y == 0) {
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = g1 - g0;
  }
  cluster.sync();
}

// pointer chase: block 0 of the cluster follows a chain in block `target`'s
// shared memory (target 0 = its own)
__global__ void dsmem_probe(int target, int iters, unsigned long long* out) {
  __shared__ int chain[1024];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) chain[i] = (i * 97 + 13) & 1023;
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const int* rp = cluster.map_shared_rank(chain, target);
    int j = 0;
    for (int i = 0; i < 16; ++i) j = rp[j];
    long long c0 = clock64();
    unsigned long long g0 = gtimer();
    for (int i = 0; i < iters; ++i) j = rp[j];
    long long c1 = clock64();
    unsigned long long g1 = gtimer();
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = g1 - g0;
    out[2] = j;
  }
  cluster.sync();
}

__global__ void l2_probe(const int* chain, int iters, unsigned long long* out) {
  int j = 0;
  for (int i = 0; i < 16; ++i) j = chain[j];
  long long c0 = clock64();
  unsigned long long g0 = gtimer();
  for (int i = 0; i < iters; ++i) j = __ldcg(chain + j);
  long long c1 = clock64();
  unsigned long long g1 = gtimer();
  out[0] = (unsigned long long)(c1 - c0);
  out[1] = g1 - g0;
  out[2] = j;
}

// (d) mode 0: ogp::Exchange; mode 1: partials in double-buffered shared
// memory, cluster.sync(), rank-order sums over DSMEM. ns per use in out[0].
__global__ void exchange_probe(int mode, int iters, int L, unsigned long long* out) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const ogp::Exchange x{reinterpret_cast<unsigned long long*>(sh), sh + 4, C, L, rank};
  float* part = x.recv + 2 * C * L;  // 2 x L
  float* sum = part + 2 * L;         // L
  ogp::exchange_init(x);
  const int j = threadIdx.x;
  const unsigned long long g0 = gtimer();
  for (int n = 0; n < iters; ++n) {
    if (mode == 0) {
      ogp::exchange_expect(x, n, L);
      if (j < L) ogp::exchange_push(x, n, j, static_cast<float>(j + n));
      ogp::exchange_wait(x, n);
      if (j < L) sum[j] = ogp::exchange_sum(x, n, j);
    } else {
      float* pn = part + (n & 1) * L;
      if (j < L) pn[j] = static_cast<float>(j + n);
      cluster.sync();
      if (j < L) {
        float v = cluster.map_shared_rank(pn, 0)[j];
        for (int r = 1; r < C; ++r) v += cluster.map_shared_rank(pn, r)[j];
        sum[j] = v;
      }
    }
    __syncthreads();
  }
  const unsigned long long g1 = gtimer();
  if (threadIdx.x == 0 && rank == 0) {
    out[0] = (g1 - g0) / iters;
    out[1] = __float_as_uint(sum[L - 1]);
  }
  cluster.sync();
}

extern "C" {

int probe_exchange(int C, int mode, int iters, int L, unsigned long long* out) {
  cudaError_t e = cudaFuncSetAttribute(exchange_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  return ogp::launch_cluster(exchange_probe, C, 1, (4 + 2LL * C * L + 3LL * L) * 4, 0, mode, iters, L,
                             out) == 0
             ? static_cast<int>(cudaDeviceSynchronize())
             : -1;
}

int probe_barrier(int C, int mode, int iters, int threads, unsigned long long* out) {
  cudaError_t e = cudaFuncSetAttribute(barrier_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  e = cudaOccupancyMaxActiveClusters(&n, barrier_probe, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return -1;
  e = cudaLaunchKernelEx(&cfg, barrier_probe, mode, iters, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

int probe_max_clusters(int C, int threads, int smem) {
  cudaFuncSetAttribute(barrier_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaFuncSetAttribute(barrier_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, barrier_probe, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

int probe_dsmem(int C, int target, int iters, unsigned long long* out) {
  cudaError_t e = cudaFuncSetAttribute(dsmem_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dsmem_probe, target, iters, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

int probe_l2(const int* chain, int iters, unsigned long long* out) {
  l2_probe<<<1, 1>>>(chain, iters, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

}
"""

# (b): a port source as it stands, its kernels stamping their stages
STAMPED = r"""
#define OGP_STAMPS
#include "{name}.cu"

extern "C" int probe_set_stamps(long long* p) {{
  return static_cast<int>(cudaMemcpyToSymbol(ogp::stamps, &p, sizeof(p)));
}}
"""
STAMP_SLOTS = 12  # ogp::kStampSlots

# the stages between a step's stamps, in order
CLUSTER_K1 = ("p0 row in", "partial a pushed", "a received", "a summed", "p", "partial Up, |p|^2 pushed",
              "Up received", "sums", "row t")
# the carried kernel's one exchange a step: Up, |p|^2 and r . p (the later
# rows, which carry their dots with P)
CARRIED_K1 = ("partial Up, |p|^2, r p pushed", "received", "sums", "P^T v, R^T v partials", "later rows updated",
              "barrier", "row t", "barrier")
CLUSTER_K3 = ("ct", "partials pushed", "received", "sums, pm, inv, r", "Z row t")
# K1's grid kernel: CLUSTER_K1's stages, of which "a summed" and "sums"
# hold the cross-cluster sums (stamps 3 -> 10 and 7 -> 11)
GRID_CROSS = {"a across clusters": (3, 10), "Up, |p|^2 across clusters": (7, 11)}
COORD_K5 = ("h, pi, s^2 partials", "barrier 1", "s^2, row t", "barrier 2")
SUB = 32  # K5 sub's sub-block size, as chip_smoke.py runs it


_built = {}


def build(name: str, source: str) -> ctypes.CDLL:
    """nvcc source into build/online_gp_torch/<name>.so, with the port's
    csrc/ on the include path, and load it (once a process)."""
    if name in _built:
        return _built[name]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"{name}.cu"
    src.write_text(source)
    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(src)],
                   check=True)
    _built[name] = ctypes.CDLL(str(so))
    return _built[name]


def stencil(g, k, side, dev):
    """(idx (k, 16) int32, w (k, 16)) of k points' 4 x 4 stencils on a
    side x side grid, weights positive and summing to 1."""
    i0 = torch.randint(0, side - 3, (k, 2), generator=g)
    off = torch.arange(4)
    idx = ((i0[:, 0, None, None] + off[:, None]) * side + i0[:, 1, None, None] + off).reshape(k, 16)
    w = torch.rand((k, 16), generator=g)
    return idx.to(torch.int32).to(dev), (w / w.sum(1, keepdim=True)).to(dev)


def stage_split(stamps, names, per_ns, k):
    """ns per stage of block 0 at steps 32, 64 and k - 1 and summed over the
    steps, from its clock64 stamps (k, STAMP_SLOTS), at per_ns cycles/ns."""
    st = stamps[: k * STAMP_SLOTS].reshape(k, STAMP_SLOTS)[:, : len(names) + 1].double().cpu()
    cyc = st[:, 1:] - st[:, :-1]
    out = {"recursion ns": float(st[k - 1, -1] - st[0, 0]) / per_ns}
    for t in (32, 64, k - 1):
        out[f"t={t}"] = {name: float(c) / per_ns for name, c in zip(names, cyc[t])}
        out[f"t={t}"]["step ns"] = float(cyc[t].sum()) / per_ns
    out["sum_over_steps_ns"] = {name: float(c) / per_ns for name, c in zip(names, cyc.sum(0))}
    return out


def cross_split(stamps, per_ns, k):
    """K1's grid kernel: block 0's cross-cluster sums of each step
    (GRID_CROSS), ns at steps 32, 64 and k - 1 and summed over the steps."""
    st = stamps[: k * STAMP_SLOTS].reshape(k, STAMP_SLOTS).double().cpu()
    out = {}
    for name, (a, b) in GRID_CROSS.items():
        d = (st[:, b] - st[:, a]) / per_ns
        out[name] = {**{f"t={t}": float(d[t]) for t in (32, 64, k - 1)}, "sum_over_steps_ns": float(d.sum())}
    return out


def boundary_split(stamps, per_ns, k, sub):
    """K5 sub's sub-block boundaries from block 0's stamps: the boundary
    after the sub-block at rows [J, J + sub) (its collapse and the next
    one's correction) runs from slot 10 to 11 at step J + sub - 1, ns."""
    st = stamps[: k * STAMP_SLOTS].reshape(k, STAMP_SLOTS).double().cpu()
    out = {f"J={J}": float(st[J + sub - 1, 11] - st[J + sub - 1, 10]) / per_ns for J in range(0, k, sub)}
    out["recursion ns"] = float(st[k - 1, 11] - st[0, 0]) / per_ns
    return out


def stamped_splits(dev, per_ns, k=128, side=30):
    """(b): the stage splits of the cluster recursions,
    K5 sub's fused cluster kernel and K5 coord's recursion at m = 900; K1's
    one-cluster kernels at m = 256; K1's grid recursion (G = 4, 8) and
    K3's 16-block one at m = 4,096."""
    m, P, Bd = side * side, 16, 1
    g = torch.Generator(device="cpu").manual_seed(0)
    W = torch.randn((m, m), generator=g, dtype=torch.float64)
    L64 = torch.linalg.cholesky(W @ W.T / m + torch.eye(m, dtype=torch.float64))
    L = L64.float().to(dev)
    B = torch.linalg.inv(L64).T.contiguous().float().to(dev)
    C = (W @ W.T / m**2 + 0.1 * torch.eye(m, dtype=torch.float64)).float().to(dev)
    mu = torch.randn(m, generator=g).to(dev)
    idx, w = stencil(g, k, side, dev)
    y = torch.randn((Bd, k), generator=g).to(dev)
    nz = torch.ones((Bd, k), device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    vp, i32, P_ = ctypes.c_void_p, ctypes.c_int, lambda t: ctypes.c_void_p(t.data_ptr())
    out = {}
    if side == 30:
        runs_root = ((8, CARRIED_K1, "K1 carried"), (8, CLUSTER_K1, "K5 sub cluster"), (1, COORD_K5, "K5 coord"))
        runs_pred = ((8, CLUSTER_K3, "K3 cluster"),)
    elif side == 16:
        runs_root = ((8, CARRIED_K1, "K1 carried"),)
        runs_pred = ()
    else:  # blocks per output: 8 G
        runs_root = ((32, CLUSTER_K1, "K1 grid G=4"), (64, CLUSTER_K1, "K1 grid G=8"))
        runs_pred = ((16, CLUSTER_K3, "K3 cluster of 16"),)
    for src, runs in (("root_update", runs_root), ("pred_stream", runs_pred)):
        if not runs:
            continue
        lib = build(f"cluster_probe_{src}", STAMPED.format(name=src))
        lib.probe_set_stamps.argtypes = [vp]
        if src == "root_update":
            lib.ogp_blocked_chunk.argtypes = [vp] * 10 + [i32] * 9 + [vp]
            lib.ogp_blocked_chunk_sub_cluster.argtypes = [vp] * 9 + [i32] * 7 + [vp]
            lib.ogp_blocked_chunk_coord.argtypes = [vp] * 9 + [i32] * 5 + [vp]
        else:
            lib.ogp_pred_chunk.argtypes = [vp] * 13 + [i32] * 9 + [vp]
        # the applies as the wrappers launch them (their stages are not stamped)
        aplan = chunk_apply_plan(k, m, m)
        AC, AM = (0 if aplan is None else aplan.cluster), pred_apply_plan(Bd, m, m, _build.card_sms(dev)).tile_rows
        for clusters, names, what in runs:
            stamps = torch.zeros(clusters * Bd * k * STAMP_SLOTS, dtype=torch.int64, device=dev)
            rc = lib.probe_set_stamps(P_(stamps))
            for _ in range(3):  # the last run's stamps are read
                if src == "root_update":
                    Lc, Bc, wv = L[None].clone(), B[None].clone(), w[None].contiguous()
                    scratch = torch.empty((4, Bd, k, m), **f32)
                    T = torch.empty((Bd, 2, m, k), **f32)
                    if what == "K5 sub cluster":
                        rc = rc or lib.ogp_blocked_chunk_sub_cluster(
                            P_(Lc), P_(Bc), P_(idx), P_(wv), *(P_(s) for s in scratch), P_(T), Bd, k, SUB, P,
                            m, AC, clusters, None)
                    elif what == "K5 coord":
                        lib.ogp_blocked_chunk_coord_splits.restype = i32
                        Mg, F, X = (torch.empty(shape, **f32) for shape in (
                            (Bd, lib.ogp_blocked_chunk_coord_splits(), k, k), (3, Bd, k, k), (3, Bd, k, m)))
                        rc = rc or lib.ogp_blocked_chunk_coord(
                            P_(Lc), P_(Bc), P_(idx), P_(wv), P_(scratch[0]), P_(Mg), P_(F), P_(X), P_(T), Bd, k,
                            P, m, AC, None)
                    else:
                        size, G = min(clusters, 8), max(clusters // 8, 1)
                        slots = torch.zeros((Bd, 2, G, k + 1), dtype=torch.int64, device=dev)
                        rc = rc or lib.ogp_blocked_chunk(
                            P_(Lc), P_(Bc), P_(idx), P_(wv), *(P_(s) for s in scratch), P_(T), P_(slots), Bd,
                            k, P, m, G, Bd, AC, size, -1, None)
                else:
                    Cc, muc = C[None].clone(), mu[None].clone()
                    bufs = torch.empty((2, Bd, k, m), **f32)
                    vecs = torch.empty((4, Bd, k), **f32)
                    rc = rc or lib.ogp_pred_chunk(
                        P_(Cc), P_(muc), P_(idx), P_(w), P_(y), P_(nz), P_(bufs[0]), P_(vecs[0]),
                        P_(bufs[1]), P_(vecs[1]), P_(vecs[2]), P_(vecs[3]), None, Bd, k, P, m, AM, clusters, 1, Bd, -1,
                        None)
                torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"stamped {what}: {rc}")
            out[what] = stage_split(stamps, names, per_ns, k)
            if what.startswith("K1 grid"):
                out[what]["cross-cluster sums"] = cross_split(stamps, per_ns, k)
            if what == "K5 sub cluster":
                out[what]["boundaries"] = boundary_split(stamps, per_ns, k, SUB)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cluster_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    lib = build("cluster_probe", SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_barrier.argtypes = [i32, i32, i32, i32, vp]
    lib.probe_max_clusters.argtypes = [i32, i32, i32]
    lib.probe_dsmem.argtypes = [i32, i32, i32, vp]
    lib.probe_l2.argtypes = [vp, i32, vp]
    lib.probe_exchange.argtypes = [i32, i32, i32, i32, vp]
    dev = torch.device("cuda", 0)
    buf = torch.zeros(8, dtype=torch.int64, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    result = {"card": smi}

    # (a) barrier round trip: (cycles, ns) per barrier, three runs each
    iters = 10000
    bar = {}
    for threads in (512, 1024):
        for C in (1, 2, 4, 8, 16):
            for mode, name in ((0, "cluster.sync"), (1, "arrive.release/wait.acquire"), (2, "__syncthreads")):
                vals = []
                for _ in range(3):
                    rc = lib.probe_barrier(C, mode, iters, threads, P(buf))
                    if rc:
                        raise RuntimeError(f"probe_barrier C={C} mode={mode}: {rc}")
                    cyc, ns = buf[:2].tolist()
                    vals.append((cyc / iters, ns / iters))
                bar[f"{name} C={C} threads={threads}"] = vals
    result["barrier_cycles_ns"] = bar
    result["max_active_clusters"] = {
        f"C={C} threads={th} smem={sm}": lib.probe_max_clusters(C, th, sm)
        for C in (2, 4, 8, 16) for th in (512, 1024) for sm in (0, 200000, 232448)}

    # (c) load latency: (cycles, ns) per load of one dependent chain
    lat = {}
    for C, target in ((2, 0), (2, 1), (8, 1), (8, 7), (16, 15)):
        rc = lib.probe_dsmem(C, target, 4096, P(buf))
        if rc:
            raise RuntimeError(f"probe_dsmem C={C}: {rc}")
        cyc, ns = buf[:2].tolist()
        lat[f"shared memory of rank {target}, cluster of {C}"] = (cyc / 4096, ns / 4096)
    n = 1 << 20  # a 4 MB chain, L2-resident
    perm = torch.randperm(n, device=dev, dtype=torch.int64).to(torch.int32)
    chain = torch.empty(n, dtype=torch.int32, device=dev)
    chain[perm] = torch.roll(perm, 1)
    for _ in range(2):
        rc = lib.probe_l2(P(chain), 4096, P(buf))
    cyc, ns = buf[:2].tolist()
    lat["L2 (4 MB chain)"] = (cyc / 4096, ns / 4096)
    result["load_latency_cycles_ns"] = lat

    # (b) stage splits of the recursions, at the SM clock of the barriers of (a)
    runs = [r for key, vals in bar.items() if "threads=512" in key for r in vals]
    per_ns = sum(c for c, _ in runs) / sum(ns for _, ns in runs)
    result["sm_cycles_per_ns"] = per_ns
    result["recursion_stage_split"] = stamped_splits(dev, per_ns)
    result["recursion_stage_split_m256"] = stamped_splits(dev, per_ns, side=16)
    result["recursion_stage_split_m4096"] = stamped_splits(dev, per_ns, side=64)

    # (d) one cross-block sum of L = 64 values: ns per use, three runs each
    xch = {}
    for C in (8, 16):
        for mode, name in ((0, "exchange (st.async, mbarrier)"), (1, "cluster.sync + DSMEM reads")):
            runs = []
            for _ in range(3):
                rc = lib.probe_exchange(C, mode, 2000, 64, P(buf))
                if rc:
                    raise RuntimeError(f"probe_exchange C={C} mode={mode}: {rc}")
                runs.append(int(buf[0]))
            xch[f"{name} C={C}"] = runs
    result["exchange_ns_per_use"] = xch

    # (e) the instructions around the first cluster-barrier arrive of barrier_probe
    so = _build.BUILD_DIR / "cluster_probe.so"
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    body = sass[sass.index("barrier_probe"):]
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", body)
    at = next(i for i, op in enumerate(ops) if "UCGABAR_ARV" in op)
    result["cluster_sync_sass"] = ops[max(0, at - 4): at + 4]
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)


if __name__ == "__main__":
    main()
