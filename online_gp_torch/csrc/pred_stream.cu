// Predict-then-condition chunk on Hopper: kernel K3 (pred_chunk) of the port,
// batched over outputs with the stencil shared. Bound to Python through a
// plain C interface (ctypes); the wrapper in
// online_gp_torch/ops/cuda_pred_stream.py checks every argument first.
//
// Replaces the Pallas kernels pallas_pred_chunk and pallas_pred_chunk_batched
// (online_gp_tpu/ops/pallas_pred_stream.py, bodies _pred_chunk_kernel and
// _pred_chunk_kernel_batched): one rank-k chunk of the prequential
// recursion of pred_chunk_factors (online_gp_tpu/ops/pred_stream.py) on the
// grid-space caches C (m, m) and mu (m,), per output:
//     a      = Z s_t                      (rows < t of Z)
//     ct     = C_0 s_t - Z^T a            (= C_{t-1} s_t)
//     pv_t   = s_t . ct,  pm_t = s_t . mu_0 + r . a
//     inv    = rsqrt(max(pv_t + nz_t, 1e-20))
//     Z[t]   = ct inv,    r_t = (y_t - pm_t) inv
// then C -= Z^T Z and mu += Z^T r. Three stages, ordered on the stream:
//   (a) gather: c0w[t] = sum_p wv[t, p] C[idx[t, p], :] (C is symmetric, so
//       this is row t of S C_0) and mu0w[t] = sum_p wv[t, p] mu[idx[t, p]];
//       the Pallas kernel multiplies a dense stencil S by the VMEM-resident C.
//   (b) recursion: one block per output. a and s_t . ct are P-sparse (P =
//       4^D), so each step has one O(t m) pass, ct = c0w[t] - Z^T a.
//   (c) apply: C -= Z^T Z as a shared-memory-tiled f32 GEMM in place, with
//       mu += Z^T r fused into the blocks of the first tile row.
// Bound: operations. C is symmetric, so C -= Z^T Z needs m (m + 1) k flops
// (a SYRK) and m (m + 1) / 2 floats of C read and written; with the recursion's
// k^2 m that is 0.12 GFLOP per output at m = 900, k = 128. The apply below
// updates all m^2 entries (the gather reads rows of C as columns, so both
// halves are kept). The single-block recursion is far above that bound and is
// the first target for speed.
//
// Not carried over from the Pallas design: the VMEM-resident C and the (k, m)
// scratch factors (Z lives in device memory here, scratch from the wrapper);
// the in-order grid whose first tile ran the recursion (three launches here);
// the padding of m to a 128-lane multiple (the kernels mask their own edge).
#include "common.cuh"

using ogp::cdiv;
using ogp::gemm_tile;
using ogp::kGemmThreads;
using ogp::kTileM;
using ogp::kTileN;
using ogp::warp_sum;

namespace {

constexpr int kRecursionThreads = 1024;

// (a) grid (k, Bd)
__global__ void pred_gather_kernel(const float* __restrict__ C, const float* __restrict__ mu,
                                   const int* __restrict__ idx, const float* __restrict__ wv,
                                   float* __restrict__ c0w, float* __restrict__ mu0w, int k,
                                   int P, int m) {
  const long long t = blockIdx.x, b = blockIdx.y, mm = m;
  const float* Cb = C + b * mm * mm;
  const int* it = idx + t * P;
  const float* wt = wv + t * P;
  float* out = c0w + (b * k + t) * mm;
  for (int l = threadIdx.x; l < m; l += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) {
      const int row = it[q];
      if ((unsigned)row < (unsigned)m) acc = fmaf(wt[q], Cb[row * mm + l], acc);
    }
    out[l] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) {
      const int row = it[q];
      if ((unsigned)row < (unsigned)m) acc = fmaf(wt[q], mu[b * mm + row], acc);
    }
    mu0w[b * k + t] = acc;
  }
}

// (b) one block per output. Rows < t of Z are read at step t, row t written.
__global__ void __launch_bounds__(kRecursionThreads)
pred_recursion_kernel(const int* __restrict__ idx, const float* __restrict__ wv,
                      const float* __restrict__ c0w, const float* __restrict__ mu0w,
                      const float* __restrict__ y, const float* __restrict__ nz, float* Z,
                      float* r, float* pm, float* pv, int k, int P, int m) {
  extern __shared__ float sh[];
  float* ct = sh;        // m
  float* a = ct + m;     // k
  float* rs = a + k;     // k: r so far
  float* inv_sh = rs + k;  // 1
  const long long b = blockIdx.x, mm = m;
  float* Zb = Z + b * k * mm;
  const float* c0b = c0w + b * k * mm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t = 0; t < k; ++t) {
    const int* it = idx + (long long)t * P;
    const float* wt = wv + (long long)t * P;
    // a_j = sum_p wv[t, p] Z[j, idx[t, p]] for j < t
    for (int j = threadIdx.x; j < t; j += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < P; ++q) {
        const int col = it[q];
        if ((unsigned)col < (unsigned)m) s = fmaf(wt[q], Zb[j * mm + col], s);
      }
      a[j] = s;
    }
    __syncthreads();
    // ct = c0w[t] - Z^T a
    for (int l = threadIdx.x; l < m; l += blockDim.x) {
      float v = c0b[t * mm + l];
      for (int j = 0; j < t; ++j) v = fmaf(-Zb[j * mm + l], a[j], v);
      ct[l] = v;
    }
    __syncthreads();
    if (warp == 0) {
      float wctw = 0.f, ra = 0.f;
      for (int q = lane; q < P; q += 32) {
        const int col = it[q];
        if ((unsigned)col < (unsigned)m) wctw = fmaf(wt[q], ct[col], wctw);
      }
      for (int j = lane; j < t; j += 32) ra = fmaf(rs[j], a[j], ra);
      wctw = warp_sum(wctw);
      ra = warp_sum(ra);
      if (lane == 0) {
        const float pmv = mu0w[b * k + t] + ra;
        const float inv = rsqrtf(fmaxf(wctw + nz[b * k + t], 1e-20f));
        const float rt = (y[b * k + t] - pmv) * inv;
        rs[t] = rt;
        r[b * k + t] = rt;
        pm[b * k + t] = pmv;
        pv[b * k + t] = wctw;
        *inv_sh = inv;
      }
    }
    __syncthreads();
    const float inv = *inv_sh;
    for (int l = threadIdx.x; l < m; l += blockDim.x) Zb[t * mm + l] = ct[l] * inv;
    __syncthreads();  // row t is read by every thread at step t + 1
  }
}

// (c) C[b] -= Z[b]^T Z[b] in place; the first tile row also does
// mu[b] += Z[b]^T r[b] for its columns. grid (m tiles, m tiles, Bd)
__global__ void __launch_bounds__(kGemmThreads)
pred_apply_kernel(float* C, float* mu, const float* Z, const float* r, int k, int m) {
  const long long b = blockIdx.z, mm = m;
  const float* Zb = Z + b * k * mm;
  // C(i, j) -= sum_t Z(t, i) Z(t, j)
  gemm_tile(m, m, k, Zb, 1, mm, Zb, mm, 1, C + b * mm * mm, mm, -1.f, true,
            blockIdx.y * kTileM, blockIdx.x * kTileN);
  if (blockIdx.y == 0) {
    for (int j = threadIdx.x; j < kTileN; j += blockDim.x) {
      const int col = blockIdx.x * kTileN + j;
      if (col >= m) continue;
      float s = 0.f;
      for (int t = 0; t < k; ++t) s = fmaf(Zb[t * mm + col], r[b * k + t], s);
      mu[b * mm + col] += s;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of the K3 recursion kernel, in bytes.
long long ogp_pred_chunk_smem(int k, int m) {
  return (static_cast<long long>(m) + 2LL * k + 1) * static_cast<long long>(sizeof(float));
}

// K3. C: (Bd, m, m) and mu: (Bd, m), updated in place; idx: (k, P) int32 and
// wv: (k, P), shared by the outputs; y, nz: (Bd, k); c0w, Z: (Bd, k, m)
// scratch; mu0w, r: (Bd, k) scratch; pm, pv: (Bd, k) outputs.
// Returns cudaGetLastError() after the launches.
int ogp_pred_chunk(float* C, float* mu, const int* idx, const float* wv, const float* y,
                   const float* nz, float* c0w, float* mu0w, float* Z, float* r, float* pm,
                   float* pv, int Bd, int k, int P, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pred_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(C, mu, idx, wv, c0w, mu0w, k, P, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long smem = ogp_pred_chunk_smem(k, m);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pred_recursion_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pred_recursion_kernel<<<Bd, kRecursionThreads, smem, s>>>(idx, wv, c0w, mu0w, y, nz, Z, r,
                                                             pm, pv, k, P, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  pred_apply_kernel<<<dim3(cdiv(m, kTileN), cdiv(m, kTileM), Bd), kGemmThreads, 0, s>>>(
      C, mu, Z, r, k, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
