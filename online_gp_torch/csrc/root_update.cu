// Maintained-root updates on Hopper: kernels K2 (rank1_apply) and K1
// (blocked_chunk) of the port. Bound to Python through a plain C interface
// (ctypes); the wrappers in online_gp_torch/ops/cuda_root_update.py check
// device, dtype, shape and contiguity before any pointer gets here.
//
// K2 replaces the Pallas kernel pallas_rank1_apply_batched
// (online_gp_tpu/ops/pallas_root_update.py, body _update_kernel_slim_batched).
// Given p = B^T v per output: u = p/|p| (u = 0 when |p| <= 1e-20, the Pallas
// guard), c = sqrt(|p|^2+1) - 1, d = 1/sqrt(|p|^2+1) - 1, then
//     L += c (L u) u^T,   B += d (B u) u^T.
// Bound: bytes. L and B are read and written once, 4 m^2 floats per output
// (13 MB at m = 900), against 8 m^2 flops. Design: a pre-pass block per
// output computes u, c and d once; then one warp per row does the row's dot
// with u and its axpy, in place (a row's update reads only that row and u).
//
// K1 replaces pallas_blocked_chunk_batched with mode="flat", sub=k (body
// _fused_chunk_kernel_batched): one chunk of k exact sequential rank-1 root
// updates, L <- L (I + R^T U), B <- B (I + P^T U), with U, P, R (k, m) from
// the k-step factor recursion of blocked_factors_xla
// (online_gp_tpu/ops/root_update.py). Three stages, ordered on the stream:
//   (a) gather: p0[t] = sum_p wv[t, p] B[idx[t, p], :]. The Pallas kernel
//       multiplies a dense stencil S by the VMEM-resident B; here the sparse
//       stencil (P = 4^D entries a row) gathers P rows of B instead.
//   (b) recursion: one block per output runs the k dependent steps, five
//       O(t m) passes each over U, P, R with block-wide reductions.
//   (c) apply: T = X A^T into scratch, then X += T U, for (X, A) = (L, R)
//       and (B, P): shared-memory-tiled f32 GEMMs, 4 m^2 k multiply-adds in
//       all. X is updated in place: the second GEMM reads only T and U.
// Bound: operations, 8 m^2 k + 5 k^2 m flops per output (0.9 GFLOP at
// m = 900, k = 128) against 4 m^2 floats of L and B traffic. The recursion
// runs on one SM per output and is far above that bound; it is left simple
// here and is the first target for speed.
//
// What does not carry over from the Pallas design: the TPU keeps B and four
// (k, m) factors in VMEM (5 MB at m = 900, k = 128); a Hopper block has at
// most 227 KB of shared memory, so the factors live in device memory
// (scratch from the wrapper, L2-resident at 1.8 MB). The Pallas grid runs in
// order, so its first row tile computes the recursion that later tiles
// read; CUDA blocks run in any order, hence the three launches above. No
// padding to 128-lane tiles: every kernel masks its own ragged edge.
#include "common.cuh"

using ogp::block_sum;
using ogp::cdiv;
using ogp::gemm_tile;
using ogp::kGemmThreads;
using ogp::kTileM;
using ogp::kTileN;
using ogp::warp_sum;

namespace {

constexpr int kRowsPerBlock = 8;  // K2: one warp per row
constexpr int kRecursionThreads = 1024;

__global__ void rank1_prepass_kernel(const float* __restrict__ p, float* __restrict__ u,
                                     float* __restrict__ cd, int m) {
  __shared__ float red[32];
  const long long b = blockIdx.x;
  const float* pb = p + b * m;
  float s2 = 0.f;
  for (int l = threadIdx.x; l < m; l += blockDim.x) s2 = fmaf(pb[l], pb[l], s2);
  s2 = block_sum(s2, red);
  const float s = sqrtf(s2);
  const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
  for (int l = threadIdx.x; l < m; l += blockDim.x) u[b * m + l] = pb[l] * inv_s;
  if (threadIdx.x == 0) {
    const float r = sqrtf(s2 + 1.f);
    cd[2 * b] = r - 1.f;
    cd[2 * b + 1] = 1.f / r - 1.f;
  }
}

// grid (row blocks, Bd, 2): z = 0 updates L with c, z = 1 updates B with d
__global__ void __launch_bounds__(kRowsPerBlock * 32)
rank1_rows_kernel(float* L, float* B, const float* __restrict__ u, const float* __restrict__ cd,
                  int m) {
  const long long b = blockIdx.y;
  const int which = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;  // whole warps leave; no block-wide sync below
  const long long mm = m;
  float* row = (which == 0 ? L : B) + b * mm * mm + i * mm;
  const float* ub = u + b * mm;
  const float coef = cd[2 * b + which];
  float dot = 0.f;
  for (int l = lane; l < m; l += 32) dot = fmaf(row[l], ub[l], dot);
  dot = warp_sum(dot) * coef;
  for (int l = lane; l < m; l += 32) row[l] = fmaf(dot, ub[l], row[l]);
}

// (a) p0[b, t, :] = sum_p wv[b, t, p] * B[b, idx[t, p], :]; grid (k, Bd)
__global__ void chunk_gather_kernel(const float* __restrict__ B, const int* __restrict__ idx,
                                    const float* __restrict__ wv, float* __restrict__ p0,
                                    int k, int P, int m) {
  const long long t = blockIdx.x, b = blockIdx.y, mm = m;
  const float* Bb = B + b * mm * mm;
  const int* it = idx + t * P;
  const float* wt = wv + (b * k + t) * P;
  float* out = p0 + (b * k + t) * mm;
  for (int l = threadIdx.x; l < m; l += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) {
      const int row = it[q];
      if ((unsigned)row < (unsigned)m) acc = fmaf(wt[q], Bb[row * mm + l], acc);
    }
    out[l] = acc;
  }
}

// (b) the k-step factor recursion, one block per output. Rows < t of U, P, R
// are read at step t and row t is written; nothing needs zeroing first.
__global__ void __launch_bounds__(kRecursionThreads)
chunk_recursion_kernel(const float* __restrict__ p0, float* U, float* Pm, float* R, int k,
                       int m) {
  extern __shared__ float sh[];
  float* q = sh;         // m: the raw row p0[t], then p
  float* u = q + m;      // m
  float* a = u + m;      // k
  float* g = a + k;      // k
  float* red = g + k;    // 32
  const long long mm = m;
  const long long off = (long long)blockIdx.x * k * mm;
  const float* p0b = p0 + off;
  float* Ub = U + off;
  float* Pb = Pm + off;
  float* Rb = R + off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int t = 0; t < k; ++t) {
    for (int l = threadIdx.x; l < m; l += blockDim.x) q[l] = p0b[t * mm + l];
    __syncthreads();
    // a_j = P_j . p0_t for j < t, one warp per row
    for (int j = warp; j < t; j += nwarps) {
      const float* row = Pb + j * mm;
      float s = 0.f;
      for (int l = lane; l < m; l += 32) s = fmaf(row[l], q[l], s);
      s = warp_sum(s);
      if (lane == 0) a[j] = s;
    }
    __syncthreads();
    // p = p0_t + U^T a, and |p|^2
    float s2 = 0.f;
    for (int l = threadIdx.x; l < m; l += blockDim.x) {
      float v = q[l];
      for (int j = 0; j < t; ++j) v = fmaf(Ub[j * mm + l], a[j], v);
      q[l] = v;
      s2 = fmaf(v, v, s2);
    }
    s2 = block_sum(s2, red);
    const float s = sqrtf(s2);
    const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
    const float r1 = sqrtf(s2 + 1.f);
    const float c = r1 - 1.f;
    const float d = 1.f / r1 - 1.f;
    for (int l = threadIdx.x; l < m; l += blockDim.x) u[l] = q[l] * inv_s;
    __syncthreads();
    // g_j = U_j . u for j < t
    for (int j = warp; j < t; j += nwarps) {
      const float* row = Ub + j * mm;
      float sg = 0.f;
      for (int l = lane; l < m; l += 32) sg = fmaf(row[l], u[l], sg);
      sg = warp_sum(sg);
      if (lane == 0) g[j] = sg;
    }
    __syncthreads();
    // row t: u, p_col = d (u + P^T g), r_col = c (u + R^T g)
    for (int l = threadIdx.x; l < m; l += blockDim.x) {
      const float ul = u[l];
      float pc = ul, rc = ul;
      for (int j = 0; j < t; ++j) {
        pc = fmaf(Pb[j * mm + l], g[j], pc);
        rc = fmaf(Rb[j * mm + l], g[j], rc);
      }
      Ub[t * mm + l] = ul;
      Pb[t * mm + l] = d * pc;
      Rb[t * mm + l] = c * rc;
    }
    __syncthreads();  // row t is read by every thread at step t + 1
  }
}

// (c1) T[b, w] = X_w[b] A_w[b]^T, (X_0, A_0) = (L, R), (X_1, A_1) = (B, P);
// T is (Bd, 2, m, k). grid (k tiles, m tiles, 2 Bd)
__global__ void __launch_bounds__(kGemmThreads)
chunk_apply_t_kernel(const float* L, const float* B, const float* R, const float* Pm, float* T,
                     int k, int m) {
  const long long b = blockIdx.z >> 1, mm = m;
  const int w = blockIdx.z & 1;
  const float* X = (w ? B : L) + b * mm * mm;
  const float* A = (w ? Pm : R) + b * k * mm;
  float* Tb = T + (b * 2 + w) * mm * k;
  // T(i, j) = sum_l X(i, l) A(j, l)
  gemm_tile(m, k, m, X, mm, 1, A, 1, mm, Tb, k, 1.f, false, blockIdx.y * kTileM,
            blockIdx.x * kTileN);
}

// (c2) X_w[b] += T[b, w] U[b], in place. grid (m tiles, m tiles, 2 Bd)
__global__ void __launch_bounds__(kGemmThreads)
chunk_apply_x_kernel(float* L, float* B, const float* T, const float* U, int k, int m) {
  const long long b = blockIdx.z >> 1, mm = m;
  const int w = blockIdx.z & 1;
  float* X = (w ? B : L) + b * mm * mm;
  const float* Tb = T + (b * 2 + w) * mm * k;
  const float* Ub = U + b * k * mm;
  gemm_tile(m, m, k, Tb, k, 1, Ub, mm, 1, X, mm, 1.f, true, blockIdx.y * kTileM,
            blockIdx.x * kTileN);
}

}  // namespace

extern "C" {

// K2. L, B: (Bd, m, m), updated in place; p: (Bd, m); u: (Bd, m) and
// cd: (Bd, 2) scratch. Returns cudaGetLastError() after the launches.
int ogp_rank1_apply(float* L, float* B, const float* p, float* u, float* cd, int Bd, int m,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rank1_prepass_kernel<<<Bd, 256, 0, s>>>(p, u, cd, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(cdiv(m, kRowsPerBlock), Bd, 2);
  rank1_rows_kernel<<<grid, kRowsPerBlock * 32, 0, s>>>(L, B, u, cd, m);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the K1 recursion kernel, in bytes.
long long ogp_blocked_chunk_smem(int k, int m) {
  return (2LL * m + 2LL * k + 32) * static_cast<long long>(sizeof(float));
}

// K1. L, B: (Bd, m, m), updated in place; idx: (k, P) int32, shared by the
// outputs; wv: (Bd, k, P); p0, U, Pm, R: (Bd, k, m) scratch; T: (Bd, 2, m, k)
// scratch. Returns cudaGetLastError() after the launches.
int ogp_blocked_chunk(float* L, float* B, const int* idx, const float* wv, float* p0,
                      float* U, float* Pm, float* R, float* T, int Bd, int k, int P, int m,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(B, idx, wv, p0, k, P, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long smem = ogp_blocked_chunk_smem(k, m);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(chunk_recursion_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chunk_recursion_kernel<<<Bd, kRecursionThreads, smem, s>>>(p0, U, Pm, R, k, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  chunk_apply_t_kernel<<<dim3(cdiv(k, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, R, Pm, T, k, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_apply_x_kernel<<<dim3(cdiv(m, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, T, U, k, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
