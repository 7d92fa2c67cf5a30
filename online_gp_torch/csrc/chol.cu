// Blocked Cholesky on Hopper: kernel K6 (blocked_cholesky) of the port.
// Bound to Python through a plain C interface (ctypes); the wrapper in
// online_gp_torch/ops/cuda_chol.py checks device, dtype, shape, block and
// contiguity before any pointer gets here.
//
// K6 replaces blocked_cholesky (online_gp_tpu/ops/pallas_chol.py, bodies
// _chol_kernel and _panel_factor_body): the lower factor of an SPD q by a
// right-looking blocked algorithm with panels of b = block columns:
//   for each panel [lo, lo + b):
//     1. factor: b masked elimination steps on the diagonal tile A_kk,
//        fused with the forward substitution for V = L_kk^{-1}; the pivot
//        guard is rsqrt(max(a_jj, 1e-30)), as in the Pallas body;
//     2. panel solve: P = A_below V^T, written over A_below;
//     3. trailing syrk: A_trail -= P P^T (lower tiles only).
//   The strict upper triangle of the result is exactly 0.
// Bound: operations, m^3/3 flops per matrix (0.243 GFLOP at m = 900, 3.6 us
// at 67 TFLOP/s f32) against 2 m^2 floats of traffic. Design: the Pallas
// kernel holds the whole (padded) matrix in VMEM and unrolls the panels;
// here the matrix stays in device memory (3.2 MB at m = 900, L2-resident)
// and each panel is three launches ordered on the stream: one block per
// matrix factors the b x b tile in shared memory (2 b^2 floats, 130 KB at
// b = 128), then two shared-memory-tiled f32 GEMMs over the card. The m
// dependent elimination steps (two block-wide barriers each) run on one SM
// per matrix and bound the time far above m^3/3 flops; they are left
// simple here. The ragged edge is masked instead of padded with the
// identity: the last panel is narrower, which gives the same factor.
//
// The upper triangle: chol_init copies the lower triangle of q and zeros the
// rest; the factor writes each L_kk with zeros above its diagonal; the syrk
// writes above the diagonal only inside its diagonal 64 x 64 tiles, which
// lie inside a later panel's diagonal tile when b is a multiple of 64 (the
// wrapper takes b = 128), so the factor of that panel zeroes them.
#include "common.cuh"

using ogp::cdiv;
using ogp::gemm_tile;
using ogp::kGemmThreads;
using ogp::kTileM;
using ogp::kTileN;

namespace {

constexpr int kPanelThreads = 1024;
constexpr int kMaxBlock = 128;
constexpr int kInitThreads = 256;

// out = tril(q); grid (row chunks, Bd)
__global__ void __launch_bounds__(kInitThreads)
chol_init_kernel(const float* __restrict__ q, float* __restrict__ out, int m) {
  const long long mm = m, off = blockIdx.y * mm * mm;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < mm * mm;
       e += (long long)gridDim.x * blockDim.x) {
    out[off + e] = e % mm <= e / mm ? q[off + e] : 0.f;
  }
}

// Step 1 on the panel [lo, lo + bs): one block per matrix. Writes L_kk into
// out (zeros above its diagonal) and V = L_kk^{-1} into V (Bd, vb, vb).
// In shared memory the tile A holds L in the columns already eliminated and
// the partially eliminated trailing part in the others (lower triangles).
__global__ void __launch_bounds__(kPanelThreads)
chol_panel_kernel(float* out, float* __restrict__ Vg, int m, int lo, int bs, int vb) {
  extern __shared__ float sh[];
  const int ld = bs + 1;
  float* A = sh;               // bs x ld
  float* V = A + bs * ld;      // bs x ld
  float* lcol = V + bs * ld;   // bs: column j of L
  float* part = lcol + bs;     // kPanelThreads: partial sums of V's row j
  const long long mm = m;
  float* Ob = out + blockIdx.x * mm * mm + lo * mm + lo;
  const int groups = blockDim.x / bs;  // V's row j: column c = tid % bs, rows i = g mod groups
  const int vc = threadIdx.x % bs, vg = threadIdx.x / bs;
  for (int e = threadIdx.x; e < bs * bs; e += blockDim.x) {
    const int i = e / bs, c = e % bs;
    A[i * ld + c] = Ob[i * mm + c];
    V[i * ld + c] = 0.f;
  }
  __syncthreads();

  float inv_prev = 0.f;
  for (int j = 0; j <= bs; ++j) {
    // finish V's row j - 1 from the partial sums of the last phase
    if (j > 0 && vg == 0 && vc < j) {
      float acc = vc == j - 1 ? 1.f : 0.f;
      for (int g = 0; g < groups; ++g) acc -= part[g * bs + vc];
      V[(j - 1) * ld + vc] = acc * inv_prev;
    }
    if (j == bs) break;
    const float inv = rsqrtf(fmaxf(A[j * ld + j], 1e-30f));
    for (int i = j + threadIdx.x; i < bs; i += blockDim.x) lcol[i] = A[i * ld + j] * inv;
    __syncthreads();
    // trailing elimination of the lower triangle, column j of L, and the
    // partial sums of V's row j: sum over i < j of L[j][i] V[i][c]
    const int n = bs - 1 - j;
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
      const int i = j + 1 + e / n, c = j + 1 + e % n;
      if (c <= i) A[i * ld + c] = fmaf(-lcol[i], lcol[c], A[i * ld + c]);
    }
    for (int i = j + threadIdx.x; i < bs; i += blockDim.x) A[i * ld + j] = lcol[i];
    if (vg < groups) {
      float acc = 0.f;
      if (vc <= j) {
        for (int i = vc + ((vg - vc % groups + groups) % groups); i < j; i += groups)
          acc = fmaf(A[j * ld + i], V[i * ld + vc], acc);
      }
      part[vg * bs + vc] = acc;
    }
    inv_prev = inv;
    __syncthreads();
  }
  __syncthreads();
  float* Vb = Vg + blockIdx.x * (long long)vb * vb;
  for (int e = threadIdx.x; e < bs * bs; e += blockDim.x) {
    const int i = e / bs, c = e % bs;
    Ob[i * mm + c] = c <= i ? A[i * ld + c] : 0.f;
    Vb[i * vb + c] = V[i * ld + c];
  }
}

// Step 2: P = A_below V^T over the rows [hi, m) of the panel's columns, in
// place. Each block owns kTileM whole rows: it copies them to shared memory
// first, so no block reads what another writes. grid (row tiles, Bd)
__global__ void __launch_bounds__(kGemmThreads)
chol_panel_solve_kernel(float* out, const float* __restrict__ Vg, int m, int lo, int b) {
  __shared__ float rows[kTileM * kMaxBlock];
  const long long mm = m;
  const int hi = lo + b;
  const int r0 = hi + blockIdx.x * kTileM;
  const int nr = min(kTileM, m - r0);
  float* P = out + blockIdx.y * mm * mm + r0 * mm + lo;
  for (int e = threadIdx.x; e < nr * b; e += blockDim.x) rows[e] = P[(e / b) * mm + e % b];
  __syncthreads();
  const float* Vb = Vg + blockIdx.y * (long long)b * b;
  // P(i, c) = sum_l rows(i, l) V(c, l); V is lower triangular, so column
  // tile c0 needs l < c0 + kTileN only
  for (int c0 = 0; c0 < b; c0 += kTileN) {
    gemm_tile(nr, b, min(b, c0 + kTileN), rows, b, 1, Vb, 1, b, P, mm, 1.f, false, 0, c0);
  }
}

// Step 3: A[hi:, hi:] -= P P^T with P = out[hi:, lo:hi], lower tiles only.
// grid (column tiles, row tiles, Bd)
__global__ void __launch_bounds__(kGemmThreads)
chol_syrk_kernel(float* out, int m, int lo, int b) {
  if (blockIdx.x > blockIdx.y) return;  // an upper tile: the whole block leaves
  const long long mm = m;
  const int hi = lo + b, n = m - hi;
  float* Ob = out + blockIdx.z * mm * mm;
  const float* P = Ob + hi * mm + lo;
  gemm_tile(n, n, b, P, mm, 1, P, 1, mm, Ob + hi * mm + hi, mm, -1.f, true, blockIdx.y * kTileM,
            blockIdx.x * kTileN);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the panel kernel at block b, in bytes.
long long ogp_chol_panel_smem(int b) {
  return (2LL * b * (b + 1) + b + kPanelThreads) * static_cast<long long>(sizeof(float));
}

// K6. q: (Bd, m, m); out: (Bd, m, m), the lower factor; V: (Bd, b, b)
// scratch; b is 128 (any multiple of 64 up to kMaxBlock would do). Returns
// cudaGetLastError() after the launches.
int ogp_blocked_cholesky(const float* q, float* out, float* V, int Bd, int m, int b,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mm = m;
  const int init_blocks = static_cast<int>((mm * mm + kInitThreads - 1) / kInitThreads);
  chol_init_kernel<<<dim3(init_blocks < 1024 ? init_blocks : 1024, Bd), kInitThreads, 0, s>>>(
      q, out, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long smem = ogp_chol_panel_smem(b);
  e = cudaFuncSetAttribute(chol_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int lo = 0; lo < m; lo += b) {
    const int bs = m - lo < b ? m - lo : b;
    chol_panel_kernel<<<Bd, kPanelThreads, ogp_chol_panel_smem(bs), s>>>(out, V, m, lo, bs, b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n = m - lo - b;
    if (n <= 0) break;
    chol_panel_solve_kernel<<<dim3(cdiv(n, kTileM), Bd), kGemmThreads, 0, s>>>(out, V, m, lo, b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_syrk_kernel<<<dim3(cdiv(n, kTileN), cdiv(n, kTileM), Bd), kGemmThreads, 0, s>>>(
        out, m, lo, b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
