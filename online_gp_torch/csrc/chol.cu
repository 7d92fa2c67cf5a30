// Blocked Cholesky on Hopper: kernel K6 (blocked_cholesky) of the port.
// Bound to Python through a plain C interface (ctypes); the wrapper in
// online_gp_torch/ops/cuda_chol.py checks device, dtype, shape and
// contiguity before any pointer gets here.
//
// K6 replaces blocked_cholesky (online_gp_tpu/ops/pallas_chol.py, bodies
// _chol_kernel and _panel_factor_body): the lower factor of an SPD q by a
// right-looking blocked algorithm with panels of kB = 128 columns:
//   for each panel [lo, lo + kB):
//     1. factor: L_kk of the diagonal tile, the pivot guard
//        rsqrt(max(a_jj, 1e-30)) as in the Pallas body;
//     2. panel solve: P = A_below L_kk^{-T};
//     3. trailing syrk: A_trail -= P P^T (lower tiles only).
//   The strict upper triangle of the result is exactly 0.
// info[b] is nonzero where some pivot a_jj of matrix b was <= 0 or not
// finite before the guard: then the matrix is not numerically SPD and the
// factor is meaningless (the Pallas kernel has no such signal; the caller
// puts NaN there, as torch.linalg.cholesky_ex's info lets it).
// Bound: operations, m^3/3 flops per matrix (0.243 GFLOP at m = 900, 3.6 us
// at 67 TFLOP/s f32) against 2 m^2 floats of traffic. What bounds it on
// this card is the dependent chain: m pivots, each needing the one before.
//
// Design. The Pallas kernel holds the whole padded matrix in VMEM and runs
// m masked elimination steps over (b, b) tiles, building V = L_kk^{-1}
// alongside. Here the matrix stays in device memory (3.2 MB at m = 900,
// L2-resident) and each panel is three kernels:
//   1. chol_factor_kernel, one block per matrix, the 128 x 128 tile in
//      shared memory, in four inner panels of 32 columns. In each, one warp
//      factors the 32 x 32 diagonal block in registers (lane i holds row i;
//      the pivot comes by __shfl_sync, each column by a broadcast through
//      shared memory, no block barrier) and forms that block's inverse W_i
//      alongside from the same column; then the block solves the tile's
//      rows below (A W_i^T) and updates the rest of the tile's lower
//      triangle 32 deep, both register-tiled over a 16 x 16 thread grid
//      with every shape fixed at compile time. 14 block barriers a panel,
//      where eliminating one column at a time takes 256. The tile is
//      loaded and stored by whole rows, every load in flight at once. It
//      writes L_kk and the four W_i; no full inverse is formed. Then warp 0
//      votes on L_kk's diagonal, and its lane 0 writes the panel's failure
//      flag, only if a pivot failed (no atomics: one block a matrix, the
//      panels in stream order).
//   2. chol_solve_kernel, 16 whole rows per block (49 blocks on the first
//      panel at m = 900), in place: blocked forward substitution over the
//      four column blocks, P_i = (A_i - sum_{k<i} P_k L_ik^T) W_i^T, with
//      L_kk and the W_i in shared memory.
//   3. chol_syrk_kernel, over the 32 x 32 tiles of the trailing lower
//      triangle only (325 blocks on the first panel).
// The launches after the first use programmatic dependent launch
// (ogp::launch with pdl): each kernel is scheduled while the one before
// runs and waits in pdl_wait() for its results. Every sum runs in a fixed
// order: the same result on every call. The ragged last panel (4 columns
// at m = 900) is padded with the identity inside the factor kernel's tile
// only.
//
// The upper triangle: chol_init copies the lower triangle of q and zeros the
// rest (and zeros info); the factor writes each L_kk with zeros above its diagonal; the syrk
// writes only on or below the diagonal.
#include <cfloat>

#include "common.cuh"

using ogp::cdiv;
using ogp::launch;
using ogp::pdl_trigger;
using ogp::pdl_wait;

namespace {

constexpr int kB = 128;        // panel width
constexpr int kIn = 32;        // inner panel width: one warp
constexpr int kNIn = kB / kIn;
constexpr int kLd = kB + 1;    // row stride of the tiles in shared memory
constexpr int kWLd = kIn + 1;  // row stride of the inner blocks' inverses
constexpr int kThreads = 256;  // a 16 x 16 thread grid (tile_mm)
constexpr int kWarps = kThreads / 32;
constexpr int kInitThreads = 256;
constexpr int kSolveRows = 16;  // panel solve: rows per block
constexpr int kSyrkTile = 32;   // trailing update: a tile per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWFloats = kNIn * kIn * kWLd;  // the four inverses W_i
// shared floats of the factor kernel (the tile, W, a column) and of the
// solve kernel (its rows, L_kk, W)
constexpr int kFactorFloats = kB * kLd + kWFloats + kIn;
constexpr int kSolveFloats = (kSolveRows + kB) * kLd + kWFloats;
static_assert(kB == 4 * kIn, "the factor kernel's inner_update cases are for four inner panels");

// acc(r, c) = sum_{l < K} X(r, l) Y(c, l) for r < 16 MR, c < 16 MC, with
// X(r, l) = X[r XR + l XC] and Y(c, l) = Y[c YR + l YC] in shared memory,
// summed in order of l. Thread (ty, tx) of the 16 x 16 grid owns
// r = ty + 16 a and c = tx + 16 b and hands each sum to epi(r, c, acc);
// with LOWER it skips the blocks b > a (their c > r). With SYNC the block
// synchronises between the last read and the first epi, so epi may
// overwrite X or Y. Called by all kThreads threads.
template <int MR, int MC, int K, int XR, int XC, int YR, int YC, bool LOWER, bool SYNC, typename Epi>
__device__ __forceinline__ void tile_mm(const float* X, const float* Y, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  X += ty * XR;
  Y += tx * YR;
  float acc[MR][MC];
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int l = 0; l < K; ++l) {
    float x[MR], y[MC];
#pragma unroll
    for (int a = 0; a < MR; ++a) x[a] = X[16 * a * XR + l * XC];
#pragma unroll
    for (int b = 0; b < MC; ++b) y[b] = Y[16 * b * YR + l * YC];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < MC; ++b)
        if (!LOWER || b <= a) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
  if (SYNC) __syncthreads();
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b)
      if (!LOWER || b <= a) epi(ty + 16 * a, tx + 16 * b, acc[a][b]);
}

// Rows [0, NROWS) of a kB-column strip into shared memory (row stride
// kLd): dst(i, c) = src[i ld + c] for i < nrows and c < ncols, else 0 (1 on
// the diagonal with pad, the identity padding of a ragged last panel).
// Warps over rows, lanes over columns; every load is issued before the
// first store. Called by all kThreads threads.
template <int NROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ld, int nrows,
                                          int ncols, bool pad = false) {
  constexpr int kIter = (NROWS + kWarps - 1) / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[kIter][kB / 32];
#pragma unroll
  for (int t = 0; t < kIter; ++t) {
    const int i = t * kWarps + warp;
#pragma unroll
    for (int q = 0; q < kB / 32; ++q) {
      const int c = lane + 32 * q;
      v[t][q] = i < nrows && c < ncols ? src[i * ld + c] : (pad && i == c ? 1.f : 0.f);
    }
  }
#pragma unroll
  for (int t = 0; t < kIter; ++t) {
    const int i = t * kWarps + warp;
    if (i < NROWS) {
#pragma unroll
      for (int q = 0; q < kB / 32; ++q) dst[i * kLd + lane + 32 * q] = v[t][q];
    }
  }
}

// dst[i ld + c] = src(i, c) for i < nrows, c < ncols: the reverse of
// load_rows. Called by all kThreads threads.
template <int NROWS>
__device__ __forceinline__ void store_rows(float* dst, long long ld, const float* src, int nrows,
                                           int ncols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = warp; i < NROWS; i += kWarps) {
    if (i >= nrows) break;
#pragma unroll
    for (int q = 0; q < kB / 32; ++q) {
      const int c = lane + 32 * q;
      if (c < ncols) dst[i * ld + c] = src[i * kLd + c];
    }
  }
}

// One warp: the 32 x 32 diagonal block of A at (c0, c0) is factored in
// registers, lane i holding row i (its upper part is never read: columns
// are masked to rows >= j). At step j each lane puts its entry of column j
// of L into col (32 floats, 16-byte aligned) and reads the column back with
// broadcast float4 loads, for its row's update and for its column of the
// block's inverse W: lane x keeps v(r) = e_x(r) - sum_{i<j} L(r, i) W(i, x),
// and W(j, x) = v(j) / L(j, j) (forward substitution, the sum in order of
// i). The pivot comes from the diagonal's lane by a shuffle: lane j + 1
// updates its diagonal entry with its own L(j + 1, j) (the value it puts
// into col) before the broadcast, so the chain from pivot to pivot is a
// shuffle, a rsqrt and two FMAs; the same FMA as its row's update, so the
// same value. L goes back into A with zeros above its diagonal, W into Ws
// (32 x kWLd).
__device__ __forceinline__ void warp_factor(float* A, float* Ws, float* col, int c0) {
  const int lane = threadIdx.x & 31;
  float a[kIn], v[kIn];
  float* row = A + (c0 + lane) * kLd + c0;
#pragma unroll
  for (int c = 0; c < kIn; ++c) {
    a[c] = row[c];
    v[c] = c == lane ? 1.f : 0.f;
  }
  const float4* col4 = reinterpret_cast<const float4*>(col);
  float piv = a[0];  // on lane j at step j: the updated A(j, j)
#pragma unroll
  for (int j = 0; j < kIn; ++j) {
    const float inv = rsqrtf(fmaxf(__shfl_sync(kFull, piv, j), 1e-30f));
    const float l = lane >= j ? a[j] * inv : 0.f;
    a[j] = l;
    if (j + 1 < kIn) piv = fmaf(-l, l, a[j + 1]);
    col[lane] = l;
    __syncwarp();
    float lc[kIn];  // lc[c] = L(c, j) for c > j
#pragma unroll
    for (int q = (j + 1) / 4; q < kIn / 4; ++q) {
      const float4 t = col4[q];
      lc[4 * q] = t.x;
      lc[4 * q + 1] = t.y;
      lc[4 * q + 2] = t.z;
      lc[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int c = j + 1; c < kIn; ++c) a[c] = fmaf(-l, lc[c], a[c]);
    const float w = v[j] * inv;
    v[j] = w;
#pragma unroll
    for (int r = j + 1; r < kIn; ++r) v[r] = fmaf(-lc[r], w, v[r]);
    __syncwarp();
  }
#pragma unroll
  for (int c = 0; c < kIn; ++c) row[c] = c <= lane ? a[c] : 0.f;
#pragma unroll
  for (int i = 0; i < kIn; ++i) Ws[i * kWLd + lane] = v[i];
}

// After the inner panel at c0 (NR rows of the tile below it): the tile's rows
// below the block, L(r, c0 + c) = sum_l A(r, c0 + l) W(c, l), then the rest
// of the tile's lower triangle, 32 deep.
template <int NR>
__device__ __forceinline__ void inner_update(float* A, const float* Ws, int c0) {
  float* below = A + (c0 + kIn) * kLd + c0;
  tile_mm<NR / 16, kIn / 16, kIn, kLd, 1, kWLd, 1, false, true>(
      below, Ws, [&](int r, int c, float s) { below[r * kLd + c] = s; });
  __syncthreads();
  float* trail = below + kIn;
  tile_mm<NR / 16, NR / 16, kIn, kLd, 1, kLd, 1, true, false>(below, below, [&](int r, int c, float s) {
    if (c <= r) trail[r * kLd + c] -= s;
  });
  __syncthreads();
}

// out = tril(q), info = 0; grid (row chunks, Bd)
__global__ void __launch_bounds__(kInitThreads)
chol_init_kernel(const float* __restrict__ q, float* __restrict__ out, int* __restrict__ info, int m) {
  pdl_trigger();
  const long long mm = m, off = blockIdx.y * mm * mm;
  if (blockIdx.x == 0 && threadIdx.x == 0) info[blockIdx.y] = 0;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < mm * mm;
       e += (long long)gridDim.x * blockDim.x) {
    out[off + e] = e % mm <= e / mm ? q[off + e] : 0.f;
  }
}

// Step 1 on the panel [lo, lo + bs), bs = min(kB, m - lo): one block per
// matrix. Writes L_kk into out (zeros above its diagonal) and, when rows
// lie below the panel, the inverses W_i of its four diagonal 32 x 32
// blocks into Wg (Bd, 4, 32, 32). A narrower last panel is padded with the
// identity to whole inner panels (pivots 1). Where a pivot failed, thread 0
// sets info[matrix] to 1.
__global__ void __launch_bounds__(kThreads)
chol_factor_kernel(float* out, float* __restrict__ Wg, int* __restrict__ info, int m, int lo) {
  extern __shared__ __align__(16) float sh[];
  float* A = sh;
  float* W = A + kB * kLd;
  float* col = W + kWFloats;  // warp_factor's column, 16-byte aligned
  pdl_wait();
  pdl_trigger();
  const long long mm = m;
  const int bs = min(kB, m - lo);
  const int n = cdiv(bs, kIn) * kIn;
  const int panels = cdiv(m, kB), panel = lo / kB;
  (void)panels;
  (void)panel;
  OGP_STAMP(panels, panel, 0);
  // out's strict upper triangle is 0 (chol_init; nothing writes there), so
  // whole rows of the tile load its lower triangle
  float* Ob = out + blockIdx.x * mm * mm + lo * mm + lo;
  load_rows<kB>(A, Ob, mm, bs, bs, true);
  __syncthreads();
  OGP_STAMP(panels, panel, 1);

  for (int c0 = 0; c0 < n; c0 += kIn) {
    float* Ws = W + (c0 / kIn) * kIn * kWLd;
    if (threadIdx.x < 32) warp_factor(A, Ws, col, c0);
    __syncthreads();
    OGP_STAMP(panels, panel, 2 + 2 * (c0 / kIn));
    switch ((n - c0) / kIn - 1) {  // inner panels below this one
      case 3: inner_update<3 * kIn>(A, Ws, c0); break;
      case 2: inner_update<2 * kIn>(A, Ws, c0); break;
      case 1: inner_update<kIn>(A, Ws, c0); break;
      default: break;
    }
    OGP_STAMP(panels, panel, 3 + 2 * (c0 / kIn));
  }

  store_rows<kB>(Ob, mm, A, bs, bs);  // A's strict upper triangle is 0
  if (threadIdx.x < 32) {
    // the failure flag, off the pivot chain: L(j, j) = p rsqrt(max(p, 1e-30))
    // is positive and finite exactly when the pivot p was (p <= 0 gives
    // L(j, j) <= 0; NaN and +inf give NaN, fmaxf passing NaN's other operand)
    bool failed = false;
    for (int j = threadIdx.x; j < bs; j += 32) {
      const float d = A[j * kLd + j];
      failed |= !(d > 0.f && d <= FLT_MAX);
    }
    if (__any_sync(kFull, failed) && threadIdx.x == 0) info[blockIdx.x] = 1;
  }
  if (lo + kB < m) {
    float* Wb = Wg + blockIdx.x * (long long)kNIn * kIn * kIn;
#pragma unroll
    for (int e = threadIdx.x; e < kNIn * kIn * kIn; e += kThreads) {
      const int blk = e / (kIn * kIn), i = (e / kIn) % kIn, c = e % kIn;
      Wb[e] = W[(blk * kIn + i) * kWLd + c];
    }
  }
  OGP_STAMP(panels, panel, 10);
}

// One column block I of the panel solve on a block's kSolveRows rows X:
// X_I -= P_{<I} L_{I,<I}^T (the blocks solved before), then P_I = X_I W_I^T.
template <int I>
__device__ __forceinline__ void solve_block(float* X, const float* Ls, const float* W) {
  float* XI = X + I * kIn;
  if (I > 0) {
    tile_mm<kSolveRows / 16, kIn / 16, I * kIn, kLd, 1, kLd, 1, false, false>(
        X, Ls + I * kIn * kLd, [&](int r, int c, float s) { XI[r * kLd + c] -= s; });
    __syncthreads();
  }
  tile_mm<kSolveRows / 16, kIn / 16, kIn, kLd, 1, kWLd, 1, false, true>(
      XI, W + I * kIn * kWLd, [&](int r, int c, float s) { XI[r * kLd + c] = s; });
  __syncthreads();
}

// Step 2: the rows below the panel, in place: P = A_below L_kk^{-T} by
// blocked forward substitution over the four column blocks (each block of
// the grid owns kSolveRows whole rows, so no block reads what another
// writes). grid (row tiles, Bd)
__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(float* out, const float* __restrict__ Wg, int m, int lo) {
  extern __shared__ __align__(16) float sh[];
  float* X = sh;                       // kSolveRows x kLd
  float* Ls = X + kSolveRows * kLd;    // kB x kLd: L_kk
  float* W = Ls + kB * kLd;            // 4 x 32 x kWLd
  pdl_wait();
  pdl_trigger();
  const long long mm = m;
  const int r0 = lo + kB + blockIdx.x * kSolveRows, nr = min(kSolveRows, m - r0);
  float* Ob = out + blockIdx.y * mm * mm;
  const float* Wb = Wg + blockIdx.y * (long long)kNIn * kIn * kIn;
  load_rows<kSolveRows>(X, Ob + r0 * mm + lo, mm, nr, kB);
  load_rows<kB>(Ls, Ob + lo * mm + lo, mm, kB, kB);
#pragma unroll
  for (int e = threadIdx.x; e < kNIn * kIn * kIn; e += kThreads) {
    const int blk = e / (kIn * kIn), i = (e / kIn) % kIn, c = e % kIn;
    W[(blk * kIn + i) * kWLd + c] = Wb[e];
  }
  __syncthreads();
  solve_block<0>(X, Ls, W);
  solve_block<1>(X, Ls, W);
  solve_block<2>(X, Ls, W);
  solve_block<3>(X, Ls, W);
  store_rows<kSolveRows>(Ob + r0 * mm + lo, mm, X, nr, kB);
}

// Step 3: A(hi + r, hi + c) -= sum_l P(r, l) P(c, l) on the 32 x 32 tiles
// (I, J), J <= I, of the trailing lower triangle, tile t = I (I + 1) / 2 + J,
// with P = out[hi:, lo:hi]. grid (lower tiles, Bd)
__global__ void __launch_bounds__(kThreads)
chol_syrk_kernel(float* out, int m, int lo) {
  __shared__ float Xs[kSyrkTile * kLd];
  __shared__ float Ys[kSyrkTile * kLd];
  pdl_wait();
  pdl_trigger();
  const int t = blockIdx.x;
  int I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (I * (I + 1) / 2 > t) --I;
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  const int J = t - I * (I + 1) / 2;
  const long long mm = m;
  const int hi = lo + kB, n = m - hi;
  const int r0 = I * kSyrkTile, c0 = J * kSyrkTile;
  const int nr = min(kSyrkTile, n - r0), nc = min(kSyrkTile, n - c0);
  float* Ob = out + blockIdx.y * mm * mm;
  const float* P = Ob + hi * mm + lo;
  load_rows<kSyrkTile>(Xs, P + r0 * mm, mm, nr, kB);
  load_rows<kSyrkTile>(Ys, P + c0 * mm, mm, nc, kB);
  __syncthreads();
  float* Ot = Ob + (hi + r0) * mm + hi + c0;
  tile_mm<kSyrkTile / 16, kSyrkTile / 16, kB, kLd, 1, kLd, 1, false, false>(
      Xs, Ys, [&](int r, int c, float s) {
        if (r < nr && c < nc && c0 + c <= r0 + r) Ot[r * mm + c] -= s;
      });
}

}  // namespace

extern "C" {

// K6. q: (Bd, m, m); out: (Bd, m, m), the lower factor; W: (Bd, 4, 32, 32)
// scratch; info: (Bd,), nonzero where a pivot failed. pdl = 0 launches every
// kernel in plain stream order (the measurement that chose programmatic
// dependent launch compares the two).
// Returns cudaGetLastError() after the launches.
int ogp_blocked_cholesky(const float* q, float* out, float* W, int* info, int Bd, int m, int pdl,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mm = m;
  const long long blocks = (mm * mm + kInitThreads - 1) / kInitThreads;
  chol_init_kernel<<<dim3(blocks < 1024 ? static_cast<int>(blocks) : 1024, Bd), kInitThreads, 0, s>>>(
      q, out, info, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t factor_smem = kFactorFloats * sizeof(float), solve_smem = kSolveFloats * sizeof(float);
  e = cudaFuncSetAttribute(chol_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(factor_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(solve_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int lo = 0; lo < m; lo += kB) {
    e = launch(chol_factor_kernel, dim3(Bd), dim3(kThreads), factor_smem, s, pdl != 0, out, W, info, m,
               lo);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n = m - lo - kB;
    if (n <= 0) break;
    e = launch(chol_solve_kernel, dim3(cdiv(n, kSolveRows), Bd), dim3(kThreads), solve_smem, s,
               pdl != 0, out, W, m, lo);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int tiles = cdiv(n, kSyrkTile);
    e = launch(chol_syrk_kernel, dim3(tiles * (tiles + 1) / 2, Bd), dim3(kThreads), 0, s, pdl != 0,
               out, m, lo);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
