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
//   3. the trailing update over the T x T tiles of the trailing lower
//      triangle only: chol_syrk_kernel at T = 32 (325 blocks on the first
//      panel at m = 900; a thread owns 2 x 2 outputs and reads two floats
//      a pair of FMAs, so it is bound by shared-memory loads), or
//      chol_trail_kernel<T> at T = 64 and 128 for the wide trailing
//      matrices (m = 1,936 and 4,096 on the paths): a thread owns 4 x 4 or
//      8 x 8 outputs, so one float4 load from shared memory feeds 16 or 32
//      FMAs, its operands read from a transposed, swizzled layout; the two
//      strips stream in 16-column slices, 16-byte loads staged in
//      registers while the slice before runs its FMAs, into two shared
//      buffers; the old values of the tile are read and written back by
//      float4s. The Python plan (cholesky_plan in ops/cuda_chol.py) picks
//      T per panel from a launch-cost model fitted on the card and hands
//      it to ogp_blocked_cholesky, which refuses a T it has no kernel for.
//      Every element sums its panel's 128 products in order of the
//      column, from 0, and is then subtracted once (tile_mm's order), so
//      every T gives the same bits.
// The launches after the first use programmatic dependent launch
// (ogp::launch with pdl): each kernel is scheduled while the one before
// runs and waits in pdl_wait() for its results. Every sum runs in a fixed
// order: the same result on every call. The ragged last panel (4 columns
// at m = 900) is padded with the identity inside the factor kernel's tile
// only.
//
// Look-ahead (the plan's choice, for wide batches): the trailing update of
// panel p splits into the next panel's column block (rows hi..m, columns
// hi..hi + 128), which the next factor waits on, and the rest. The factor,
// the solve and the next block run on a stream of the highest priority,
// the rest on the caller's stream, joined by two events: the rest of panel
// p waits for panel p's solve, the next block of panel p + 1 for the rest
// of panel p (both update columns of panel p + 2). So panel p + 1's factor
// and solve overlap panel p's rest, and every element still takes the
// panels' updates in panel order: the same bits as without look-ahead.
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
constexpr int kSyrkTile = 32;   // chol_syrk_kernel: a 32 x 32 tile per block
constexpr int kTrailK = 16;     // chol_trail_kernel: panel columns a slice
constexpr int kTrailSlices = kB / kTrailK;
constexpr int kTrailStages = 2;  // slice buffers in shared memory
constexpr int kBadPlan = -2;     // ogp_blocked_cholesky: the plan asks for a tile it has no kernel for
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

// The tile (I, J) of tiles of T that block t of a trailing-update launch
// of panel lo owns, over the trailing matrix of width n = m - lo - kB
// (nt = cdiv(n, T) tiles a side): with jn > 0 the tiles of the first jn
// tile columns, t = I jn + J (blocks with J > I own nothing), else the
// lower triangle from tile column j0 on, t = I' (I' + 1) / 2 + J' with
// (I, J) = (I' + j0, J' + j0). False where the block owns no tile.
__device__ __forceinline__ bool trail_tile(int t, int j0, int jn, int& I, int& J) {
  if (jn > 0) {
    I = t / jn;
    J = t - I * jn;
    return J <= I;
  }
  I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (I * (I + 1) / 2 > t) --I;
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  J = t - I * (I + 1) / 2 + j0;
  I += j0;
  return true;
}

// Step 3 at T = 32: A(hi + r, hi + c) -= sum_l P(r, l) P(c, l) on the tiles
// (I, J) of trail_tile, J <= I, with P = out[hi:, lo:hi]. grid (tiles, Bd)
__global__ void __launch_bounds__(kThreads)
chol_syrk_kernel(float* out, int m, int lo, int j0, int jn) {
  __shared__ float Xs[kSyrkTile * kLd];
  __shared__ float Ys[kSyrkTile * kLd];
  pdl_wait();
  pdl_trigger();
  int I, J;
  if (!trail_tile(blockIdx.x, j0, jn, I, J)) return;
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

// Floats of shared memory chol_trail_kernel<T> takes: two buffers, each a
// kTrailK-column slice of the two strips of T rows.
template <int T>
__host__ __device__ constexpr int trail_floats() {
  return kTrailStages * 2 * kTrailK * T;
}

// The swizzle of column l of a slice stored transposed: P(r, l) sits at
// [l T + (r ^ trail_sw(l))]. It flips bits 3-4 of the row, so each aligned
// group of 4 rows stays whole (a float4 for the reader) and a warp's stores
// (4 columns of 8 rows, one row each from its 4 float4s) hit 32 banks.
__device__ __forceinline__ int trail_sw(int l) { return ((l >> 2) & 3) << 3; }

// Float4s of one strip's slice a thread stages in registers.
template <int T>
__host__ __device__ constexpr int trail_regs() {
  static_assert(T * kTrailK % (4 * kThreads) == 0, "whole float4s a thread");
  return T * kTrailK / (4 * kThreads);
}

// Slice s of a strip of T rows of P (row stride ld, nr rows valid) into
// registers: float4 i of a thread is P(r, s kTrailK + 4 g ...) with
// g = e % 4, r = e / 4, e = i kThreads + threadIdx.x (a warp reads 8 rows of
// 64 bytes: whole sectors). Rows past nr are zeros. With vec (m % 4 == 0)
// one 16-byte load, else four 4-byte loads.
template <int T>
__device__ __forceinline__ void trail_load(float4 (&v)[trail_regs<T>()], const float* src, long long ld, int nr,
                                           int s, bool vec) {
#pragma unroll
  for (int i = 0; i < trail_regs<T>(); ++i) {
    const int e = i * kThreads + threadIdx.x, r = e >> 2;
    const float* p = src + r * ld + s * kTrailK + 4 * (e & 3);
    if (r >= nr)
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    else if (vec)
      v[i] = *reinterpret_cast<const float4*>(p);
    else
      v[i] = make_float4(p[0], p[1], p[2], p[3]);
  }
}

// The staged float4s into a slice buffer, transposed and swizzled.
template <int T>
__device__ __forceinline__ void trail_store(float* dst, const float4 (&v)[trail_regs<T>()]) {
#pragma unroll
  for (int i = 0; i < trail_regs<T>(); ++i) {
    const int e = i * kThreads + threadIdx.x, r = e >> 2, l = 4 * (e & 3);
    dst[l * T + (r ^ trail_sw(l))] = v[i].x;
    dst[(l + 1) * T + (r ^ trail_sw(l + 1))] = v[i].y;
    dst[(l + 2) * T + (r ^ trail_sw(l + 2))] = v[i].z;
    dst[(l + 3) * T + (r ^ trail_sw(l + 3))] = v[i].w;
  }
}

// The FMAs of one slice: acc(a, b) += X(ra, l) Y(cb, l) for the slice's
// columns l in order, thread (ty, tx) owning rows ra = 4 ty + 64 (a / 4) +
// a % 4 and columns cb = 4 tx + 64 (b / 4) + b % 4. DIAG skips the outputs
// of a diagonal tile that lie above its diagonal by whole 64 x 64 blocks.
template <int T, bool DIAG>
__device__ __forceinline__ void trail_fma(const float* Xs, const float* Ys, float (&acc)[T / 16][T / 16]) {
  constexpr int R = T / 16, H = T / 64;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int l = 0; l < kTrailK; ++l) {
    const int sw = trail_sw(l);
    float x[R], y[R];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float4 u = *reinterpret_cast<const float4*>(Xs + l * T + ((4 * ty + 64 * h) ^ sw));
      const float4 v = *reinterpret_cast<const float4*>(Ys + l * T + ((4 * tx + 64 * h) ^ sw));
      x[4 * h] = u.x, x[4 * h + 1] = u.y, x[4 * h + 2] = u.z, x[4 * h + 3] = u.w;
      y[4 * h] = v.x, y[4 * h + 1] = v.y, y[4 * h + 2] = v.z, y[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b)
        if (!DIAG || b / 4 <= a / 4) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// Step 3 at T = 64 or 128 on tile (I, J) of trail_tile: the two strips of P
// (rows r0 and c0; one strip on a diagonal tile) slice by slice through
// registers into two shared buffers (slice s + 1's loads in flight during
// slice s's FMAs, one barrier a slice), the FMAs in registers, then
// Ot -= acc on and below the diagonal.
template <int T, bool DIAG>
__device__ __forceinline__ void trail_tile_update(float* sh, const float* P, float* Ot, long long mm, int r0,
                                                  int c0, int nr, int nc, bool vec) {
  constexpr int R = T / 16, H = T / 64, kSlice = kTrailK * T;
  static_assert(kTrailStages == 2, "the slices alternate between two buffers");
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
  const float* Xg = P + r0 * mm;
  const float* Yg = P + c0 * mm;
  float4 sx[trail_regs<T>()], sy[trail_regs<T>()];
  trail_load<T>(sx, Xg, mm, nr, 0, vec);
  if (!DIAG) trail_load<T>(sy, Yg, mm, nc, 0, vec);
  trail_store<T>(sh, sx);
  if (!DIAG) trail_store<T>(sh + kSlice, sy);
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < kTrailSlices; ++s) {
    const bool more = s + 1 < kTrailSlices;
    if (more) {
      trail_load<T>(sx, Xg, mm, nr, s + 1, vec);
      if (!DIAG) trail_load<T>(sy, Yg, mm, nc, s + 1, vec);
    }
    const float* Xs = sh + (s & 1) * 2 * kSlice;
    trail_fma<T, DIAG>(Xs, DIAG ? Xs : Xs + kSlice, acc);
    if (more) {  // the other buffer: every thread passed the barrier after reading it
      float* Xn = sh + ((s + 1) & 1) * 2 * kSlice;
      trail_store<T>(Xn, sx);
      if (!DIAG) trail_store<T>(Xn + kSlice, sy);
    }
    __syncthreads();
  }
  // Ot -= acc by float4s (a thread's 4 columns of a row are contiguous),
  // element by element where a float4 would cross the tile's edge or the
  // diagonal or m % 4 != 0; in groups of rows whose old values are all
  // loaded before the first store: the compiler cannot tell Ot's elements
  // apart, so it would otherwise wait out one load's latency at a time
  constexpr int G = R < 8 / H ? R : 8 / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a0 = 0; a0 < R; a0 += G) {
    float4 o[G][H];
#pragma unroll
    for (int a = 0; a < G; ++a) {
      const int r = 4 * ty + 64 * ((a0 + a) / 4) + (a0 + a) % 4;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int c = 4 * tx + 64 * h;
        const float* src = Ot + r * mm + c;
        if (vec && r < nr && c + 3 < nc && (!DIAG || c + 3 <= r)) {
          o[a][h] = *reinterpret_cast<const float4*>(src);
        } else {
          auto keep = [&](int q) { return r < nr && c + q < nc && (!DIAG || c + q <= r); };
          o[a][h] = make_float4(keep(0) ? src[0] : 0.f, keep(1) ? src[1] : 0.f, keep(2) ? src[2] : 0.f,
                                keep(3) ? src[3] : 0.f);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < G; ++a) {
      const int r = 4 * ty + 64 * ((a0 + a) / 4) + (a0 + a) % 4;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int c = 4 * tx + 64 * h;
        float* dst = Ot + r * mm + c;
        const float* ac = acc[a0 + a] + 4 * h;
        const float4 v = make_float4(o[a][h].x - ac[0], o[a][h].y - ac[1], o[a][h].z - ac[2], o[a][h].w - ac[3]);
        if (vec && r < nr && c + 3 < nc && (!DIAG || c + 3 <= r)) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          auto keep = [&](int q) { return r < nr && c + q < nc && (!DIAG || c + q <= r); };
          if (keep(0)) dst[0] = v.x;
          if (keep(1)) dst[1] = v.y;
          if (keep(2)) dst[2] = v.z;
          if (keep(3)) dst[3] = v.w;
        }
      }
    }
  }
}

// Step 3 at T = 64 and 128: A(hi + r, hi + c) -= sum_l P(r, l) P(c, l) on
// the tiles (I, J) of trail_tile, J <= I, with P = out[hi:, lo:hi]; each
// element's sum in order of l from 0, as tile_mm's. grid (tiles, Bd)
template <int T>
__global__ void __launch_bounds__(kThreads, T == 128 ? 2 : 3)
chol_trail_kernel(float* out, int m, int lo, int j0, int jn) {
  __shared__ __align__(16) float sh[trail_floats<T>()];
  pdl_wait();
  pdl_trigger();
  int I, J;
  if (!trail_tile(blockIdx.x, j0, jn, I, J)) return;
  const long long mm = m;
  const int hi = lo + kB, n = m - hi;
  const int r0 = I * T, c0 = J * T;
  const int nr = min(T, n - r0), nc = min(T, n - c0);
  float* Ob = out + blockIdx.y * mm * mm;
  const float* P = Ob + hi * mm + lo;
  float* Ot = Ob + (hi + r0) * mm + hi + c0;
  const bool vec = (m & 3) == 0;  // rows of P and of Ot start 16-byte aligned
  if (I == J)
    trail_tile_update<T, true>(sh, P, Ot, mm, r0, c0, nr, nc, vec);
  else
    trail_tile_update<T, false>(sh, P, Ot, mm, r0, c0, nr, nc, vec);
}

// Shared memory of the trailing update's block at T; -1 for a T with no
// kernel.
int trail_smem(int T) {
  switch (T) {
    case 32: return 2 * kSyrkTile * kLd * static_cast<int>(sizeof(float));
    case 64: return trail_floats<64>() * static_cast<int>(sizeof(float));
    case 128: return trail_floats<128>() * static_cast<int>(sizeof(float));
    default: return -1;
  }
}

// Launches panel lo's trailing update on tiles of T (a T of trail_smem):
// the first jn tile columns when jn > 0, else the lower triangle from tile
// column j0 (nothing when that is empty). grid (tiles, Bd)
cudaError_t launch_trail(int T, float* out, int Bd, int m, int lo, int j0, int jn, cudaStream_t s, bool pdl) {
  const int nt = cdiv(m - lo - kB, T);
  const int side = nt - j0, blocks = jn > 0 ? nt * jn : (side > 0 ? side * (side + 1) / 2 : 0);
  if (blocks <= 0) return cudaSuccess;
  const dim3 grid(blocks, Bd);
  switch (T) {
    case 32: return launch(chol_syrk_kernel, grid, dim3(kThreads), 0, s, pdl, out, m, lo, j0, jn);
    case 64: return launch(chol_trail_kernel<64>, grid, dim3(kThreads), 0, s, pdl, out, m, lo, j0, jn);
    default: return launch(chol_trail_kernel<128>, grid, dim3(kThreads), 0, s, pdl, out, m, lo, j0, jn);
  }
}

// The stream and events of look-ahead, made once per device and host thread:
// a stream of the highest priority for the panel chain, and the two events
// that join it with the caller's stream.
struct Lookahead {
  bool made = false;
  cudaStream_t chain;
  cudaEvent_t chain_done, rest_done;
};

constexpr int kMaxDevices = 64;

cudaError_t lookahead_streams(Lookahead*& out) {
  static thread_local Lookahead per_device[kMaxDevices];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Lookahead& la = per_device[dev];
  if (!la.made) {
    int least, greatest;
    if ((e = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess) return e;
    if ((e = cudaStreamCreateWithPriority(&la.chain, cudaStreamNonBlocking, greatest)) != cudaSuccess) return e;
    if ((e = cudaEventCreateWithFlags(&la.chain_done, cudaEventDisableTiming)) != cudaSuccess) return e;
    if ((e = cudaEventCreateWithFlags(&la.rest_done, cudaEventDisableTiming)) != cudaSuccess) return e;
    la.made = true;
  }
  out = &la;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The shared memory of a block of K6's trailing update at tile T, in bytes,
// or -1 where T has no kernel: the wrapper holds its plan to it.
int ogp_chol_trail_smem(int T) { return trail_smem(T); }

// K6. q: (Bd, m, m); out: (Bd, m, m), the lower factor; W: (Bd, 4, 32, 32)
// scratch; info: (Bd,), nonzero where a pivot failed. The plan (cholesky_plan
// in ops/cuda_chol.py), for each of the npanels = cdiv(m, 128) - 1 panels
// with a trailing matrix: tiles[p], the tile of its trailing update (with
// lookahead, of the rest), and with lookahead next_tiles[p], the tile of the
// next panel's column block. pdl = 0 launches every kernel in plain stream
// order (the measurement that chose programmatic dependent launch compares
// the two). Returns kBadPlan (-2), launching nothing, where the plan is not
// of this layout (a panel count other than m's, a tile with no kernel);
// else cudaGetLastError() after the launches.
int ogp_blocked_cholesky(const float* q, float* out, float* W, int* info, int Bd, int m, int pdl, int lookahead,
                         const int* tiles, const int* next_tiles, int npanels, void* stream) {
  if (npanels != (m > kB ? cdiv(m, kB) - 1 : 0)) return kBadPlan;
  for (int p = 0; p < npanels; ++p) {
    if (trail_smem(tiles[p]) < 0 || (lookahead && trail_smem(next_tiles[p]) < 0)) return kBadPlan;
  }
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
  Lookahead* la = nullptr;
  if (lookahead) {
    if ((e = lookahead_streams(la)) != cudaSuccess) return static_cast<int>(e);
    // the chain starts after chol_init on the caller's stream
    if ((e = cudaEventRecord(la->chain_done, s)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaStreamWaitEvent(la->chain, la->chain_done, 0)) != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t c = lookahead ? la->chain : s;  // the factor, the solve and the next column block
  for (int lo = 0, p = 0; lo < m; lo += kB, ++p) {
    e = launch(chol_factor_kernel, dim3(Bd), dim3(kThreads), factor_smem, c, pdl != 0 && (!lookahead || p > 0),
               out, W, info, m, lo);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n = m - lo - kB;
    if (n <= 0) break;
    e = launch(chol_solve_kernel, dim3(cdiv(n, kSolveRows), Bd), dim3(kThreads), solve_smem, c, pdl != 0, out, W,
               m, lo);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!lookahead) {
      e = launch_trail(tiles[p], out, Bd, m, lo, 0, 0, s, pdl != 0);
      if (e != cudaSuccess) return static_cast<int>(e);
      continue;
    }
    // the rest of panel p (tile columns past the next panel's block) on the
    // caller's stream after panel p's solve; the next block on the chain
    // after the rest of panel p - 1 (rest_done's last record)
    if ((e = cudaEventRecord(la->chain_done, c)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaStreamWaitEvent(s, la->chain_done, 0)) != cudaSuccess) return static_cast<int>(e);
    e = launch_trail(tiles[p], out, Bd, m, lo, kB / tiles[p], 0, s, false);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (p > 0 && (e = cudaStreamWaitEvent(c, la->rest_done, 0)) != cudaSuccess) return static_cast<int>(e);
    e = launch_trail(next_tiles[p], out, Bd, m, lo, 0, kB / next_tiles[p], c, false);
    if (e != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaEventRecord(la->rest_done, s)) != cudaSuccess) return static_cast<int>(e);
  }
  if (lookahead) {  // the caller's stream resumes after the chain's last factor
    if ((e = cudaEventRecord(la->chain_done, c)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaStreamWaitEvent(s, la->chain_done, 0)) != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
