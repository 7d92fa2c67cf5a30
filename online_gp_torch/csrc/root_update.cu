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
// output computes |p|^2 once; then one warp per row forms c, d and 1/|p|
// from it, does the row's dot with u = p/|p| and its axpy, in place (a
// row's update reads only that row and p), with the row in registers up
// to m = 1,024 so that it is read once and all its loads are in flight.
//
// K1 replaces pallas_blocked_chunk_batched with mode="flat", sub=k (body
// _fused_chunk_kernel_batched): one chunk of k exact sequential rank-1 root
// updates, L <- L (I + R^T U), B <- B (I + P^T U), with U, P, R (k, m) from
// the k-step factor recursion of blocked_factors_xla
// (online_gp_tpu/ops/root_update.py). Three stages, ordered on the stream:
//   (a) gather: p0[t] = sum_p wv[t, p] B[idx[t, p], :]. The Pallas kernel
//       multiplies a dense stencil S by the VMEM-resident B; here the sparse
//       stencil (P = 4^D entries a row) gathers P rows of B instead.
//   (b) recursion, on a thread-block cluster: C = 8 blocks per output (the
//       portable cluster size), block r owning columns [r W, r W + W), W =
//       cdiv(m, C). Each block keeps its columns of U, P and R (k rows) in
//       its own shared memory, so every O(t m) pass of a step reads shared
//       memory, on C SMs at once. Step t:
//         1. partial a_j = P_j . p0_t over the block's columns, j < t,
//            pushed to every block (ogp::Exchange: st.async into each
//            block's receive buffer, completing on its mbarrier); each
//            block adds the C partials in rank order, so all hold the
//            same a.
//         2. p = p0_t + U^T a on the slice; partials of (U p)_j and |p|^2,
//            exchanged the same way; s = |p|, g = (U p) / s (one reduction
//            where the plain recursion has two: g = U u).
//         3. u = p / s (u = 0 when s <= 1e-20, the Pallas guard); row t:
//            u, P_t = d (u + P^T g), R_t = c (u + R^T g) on the slice.
//       The slices go to the (Bd, k, m) scratch of the applies after the
//       last step. No cluster barrier inside the loop: on this card one
//       compiles to a GPU-scope fence (MEMBAR.ALL.GPU) and cost 0.65-0.74
//       us; an exchange's wait is 0.04-0.2 us. Shapes whose slice does not
//       fit a block (3 k ld floats, the receive buffers and the vectors
//       over 227 KB at C = 8: m > 1,120 at k = 128) run the single-block
//       kernel instead, one block per output with the rows of U, P, R in
//       L2. The rule is by shape only, chunk_cluster_plan in
//       online_gp_torch/ops/cuda_root_update.py, mirroring
//       chunk_cluster_layout below (the wrapper checks the two agree).
//   (c) apply: T = X A^T into scratch, then X += T U, for (X, A) = (L, R)
//       and (B, P): shared-memory-tiled f32 GEMMs, 4 m^2 k multiply-adds in
//       all. X is updated in place: the second GEMM reads only T and U.
// Bound: operations, 8 m^2 k + 5 k^2 m flops per output (0.9 GFLOP at
// m = 900, k = 128) against 4 m^2 floats of L and B traffic. The recursion
// is bound by latency on this card: at t = 64 a step is ~4.4 us of short
// stages (row and column passes over ~36 K floats of shared memory per
// block, two exchanges, six block barriers), each a chain of dependent
// shared-memory loads and shuffles. The single-block kernel reads U, P, R
// from L2 at one SM's rate (~75 GB/s on an H100, 16.5 us a step at
// t = 64). cluster_probe.py measures both splits, building this file with
// OGP_STAMPS (common.cuh) so that the kernels stamp their stages.
//
// What does not carry over from the Pallas design: the TPU keeps B and four
// (k, m) factors in VMEM (5 MB at m = 900, k = 128); a Hopper block has at
// most 227 KB of shared memory, so the factors are split over the blocks of
// a cluster (and B stays in device memory). The Pallas grid runs in order,
// so its first row tile computes the recursion that later tiles read; CUDA
// blocks run in any order, hence the three launches above. No padding to
// 128-lane tiles: every kernel masks its own ragged edge.
//
// K4 replaces pallas_rank1_update(_slim)(_batched) (bodies _p_kernel,
// _update_kernel, _update_kernel_slim and their _batched forms), reached
// through pallas_root_cache_update: the dense-v rank-1 update, p = B^T v
// first, then K2's update, plus A += v v^T in the full variant.
// Bound: bytes, (6 m^2 + m) floats per output in and out (4 m^2 + m slim).
// The kernels move 7 m^2 (5 m^2): B is read twice, once for p and once to
// update it. Design: the Pallas grid carries p across its sequential row
// tiles; CUDA blocks cannot, so pass 1 gives each block a tile of
// kPCols columns across all m rows (113 blocks at m = 900): lanes over
// columns and rows, warps over rows, the row slots added in a fixed order.
// It writes whole entries of p and one partial |p|^2 per block. Pass 2 is
// K2's row kernel: each warp adds the blocks' partials in the same fixed
// order, so no pass stands between the two and every run gives the same
// sums (no atomics, no counter). Pass 2 also does A += v v^T, by whole
// rows (pass 1 reads B by 32-byte column strips, which made A's
// read-modify-write there cost more than B's read). Pass 2 is launched
// with programmatic dependent launch: its launch overlaps pass 1, and its
// A rows, which need nothing from pass 1, run alongside it.
//
// K5 replaces the two options of pallas_blocked_chunk_batched that K1 does
// not cover, the same k exact sequential rank-1 updates:
//   sub (sub < k; body _fused_chunk_kernel_batched): the flat recursion runs
//       inside sub-blocks of `sub` rows, so a step reads at most `sub` rows
//       of U, P, R instead of t. Sub-block j's raw rows are gathered, then
//       corrected by the earlier sub-blocks (q += (q P_i^T) U_i, two small
//       GEMMs per pair), then factored by K1's recursion kernel at k = sub.
//       The factors are kept in (nb, Bd, sub, m) layout so K1's gather,
//       recursion and apply kernels run unchanged on each sub-block; the
//       applies run in stream order, one per sub-block.
//   coord (body _fused_chunk_kernel_coord): the recursion runs on k-dim
//       coordinates with inner products through M = P0 P0^T, k x k rows
//       instead of k x m. M, Ut and Pt (64 KB each at k = 128) live in
//       shared memory; Rt, read once a step against twice for Ut and Pt,
//       stays in device memory (L2), each column touched by one thread
//       only. The apply is X += ((X P0^T) T) P0 with T = Rt^T Ut (L) or
//       Pt^T Ut (B): K1's two apply kernels around one more tiled GEMM.
// Bound: operations, as K1: the applies' 8 m^2 k flops per output dominate
// (0.83 GFLOP at m = 900, k = 128). The sub recursions run on K1's kernels
// (cluster or single block, by the same shape rule at k = sub); the coord
// recursion stays one block per output.
#include "common.cuh"

using ogp::block_sum;
using ogp::cdiv;
using ogp::ColSplit;
using ogp::ColTask;
using ogp::col_partials;
using ogp::col_sum;
using ogp::gemm_tile;
using ogp::kClusterRegs;
using ogp::kClusterThreads;
using ogp::kGemmThreads;
using ogp::kTileM;
using ogp::kTileN;
using ogp::warp_sum;
namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerBlock = 8;  // K2: one warp per row
constexpr int kRowRegs = 32;      // K2: a row's entries per lane held in registers
constexpr int kRecursionThreads = 1024;

// K2's pre-pass: s2[b] = |p_b|^2, the single partial of the row kernel.
__global__ void rank1_prepass_kernel(const float* __restrict__ p, float* __restrict__ s2, int m) {
  __shared__ float red[32];
  const long long b = blockIdx.x;
  const float* pb = p + b * m;
  float acc = 0.f;
  for (int l = threadIdx.x; l < m; l += blockDim.x) acc = fmaf(pb[l], pb[l], acc);
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) s2[b] = acc;
}

// grid (row blocks, Bd, 2 or 3): z = 0 updates L with c, z = 1 updates B
// with d, z = 2 (K4's full variant) does A += v v^T, rounded as the plain
// version's A + v v^T (product, then sum). |p|^2 is the sum of the nparts
// partials s2[b, :] (lane l adds l, l + 32, ... in turn, then a fixed
// butterfly: every warp gets the same value); then s = |p|, u = p/s (u = 0
// when s <= 1e-20, the Pallas guard), c = sqrt(s^2 + 1) - 1,
// d = 1/sqrt(s^2 + 1) - 1. The A rows read nothing the kernel before
// wrote, so they run before its pdl_wait().
__global__ void __launch_bounds__(kRowsPerBlock * 32)
rank1_rows_kernel(float* L, float* B, float* A, const float* __restrict__ v,
                  const float* __restrict__ p, const float* __restrict__ s2, int nparts, int m) {
  const long long b = blockIdx.y, mm = m;
  const int which = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;  // whole warps leave; no block-wide sync below
  if (which == 2) {
    float* row = A + b * mm * mm + i * mm;
    const float* vb = v + b * mm;
    const float vi = vb[i];
    for (int l = lane; l < m; l += 32) row[l] = __fadd_rn(row[l], __fmul_rn(vi, vb[l]));
    return;
  }
  ogp::pdl_wait();
  // the row's dot with p first: its loads do not wait on the scalars. Up to
  // m = 32 kRowRegs the warp keeps its row and p in registers, every load
  // in flight at once, and reads the row once.
  float* row = (which == 0 ? L : B) + b * mm * mm + i * mm;
  const float* pb = p + b * mm;
  float x[kRowRegs], pv[kRowRegs];
  const bool in_regs = m <= 32 * kRowRegs;
  float dot = 0.f;
  if (in_regs) {
#pragma unroll
    for (int t = 0; t < kRowRegs; ++t) {
      const int l = lane + 32 * t;
      x[t] = l < m ? row[l] : 0.f;
      pv[t] = l < m ? pb[l] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kRowRegs; ++t) dot = fmaf(x[t], pv[t], dot);
  } else {
    for (int l = lane; l < m; l += 32) dot = fmaf(row[l], pb[l], dot);
  }
  float ss = 0.f;
  for (int q = lane; q < nparts; q += 32) ss += s2[b * nparts + q];
  ss = warp_sum(ss);
  const float s = sqrtf(ss);
  const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
  const float r = sqrtf(ss + 1.f);
  const float coef = which == 0 ? r - 1.f : 1.f / r - 1.f;
  // (row . u) coef with u = p inv_s
  dot = warp_sum(dot) * inv_s * coef;
  if (in_regs) {
#pragma unroll
    for (int t = 0; t < kRowRegs; ++t) {
      const int l = lane + 32 * t;
      if (l < m) row[l] = fmaf(dot, pv[t] * inv_s, x[t]);
    }
  } else {
    for (int l = lane; l < m; l += 32) row[l] = fmaf(dot, pb[l] * inv_s, row[l]);
  }
}

// The row pass of K2 and K4; A and v only for K4's full variant (else null).
cudaError_t rank1_rows(float* L, float* B, float* A, const float* v, const float* p,
                       const float* s2, int nparts, int Bd, int m, bool pdl, cudaStream_t s) {
  return ogp::launch(rank1_rows_kernel, dim3(cdiv(m, kRowsPerBlock), Bd, A ? 3 : 2),
                     dim3(kRowsPerBlock * 32), 0, s, pdl, L, B, A, v, p, s2, nparts, m);
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
    OGP_STAMP(k, t, 0);
    for (int l = threadIdx.x; l < m; l += blockDim.x) q[l] = p0b[t * mm + l];
    __syncthreads();
    OGP_STAMP(k, t, 1);
    // a_j = P_j . p0_t for j < t, one warp per row
    for (int j = warp; j < t; j += nwarps) {
      const float* row = Pb + j * mm;
      float s = 0.f;
      for (int l = lane; l < m; l += 32) s = fmaf(row[l], q[l], s);
      s = warp_sum(s);
      if (lane == 0) a[j] = s;
    }
    __syncthreads();
    OGP_STAMP(k, t, 2);
    // p = p0_t + U^T a, and |p|^2
    float s2 = 0.f;
    for (int l = threadIdx.x; l < m; l += blockDim.x) {
      float v = q[l];
      for (int j = 0; j < t; ++j) v = fmaf(Ub[j * mm + l], a[j], v);
      q[l] = v;
      s2 = fmaf(v, v, s2);
    }
    s2 = block_sum(s2, red);
    OGP_STAMP(k, t, 3);
    const float s = sqrtf(s2);
    const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
    const float r1 = sqrtf(s2 + 1.f);
    const float c = r1 - 1.f;
    const float d = 1.f / r1 - 1.f;
    for (int l = threadIdx.x; l < m; l += blockDim.x) u[l] = q[l] * inv_s;
    __syncthreads();
    OGP_STAMP(k, t, 4);
    // g_j = U_j . u for j < t
    for (int j = warp; j < t; j += nwarps) {
      const float* row = Ub + j * mm;
      float sg = 0.f;
      for (int l = lane; l < m; l += 32) sg = fmaf(row[l], u[l], sg);
      sg = warp_sum(sg);
      if (lane == 0) g[j] = sg;
    }
    __syncthreads();
    OGP_STAMP(k, t, 5);
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
    OGP_STAMP(k, t, 6);
  }
}

// Shared-memory layout of one block of the cluster recursion;
// chunk_cluster_plan (online_gp_torch/ops/cuda_root_update.py) mirrors it.
// A row pass gives Sr lanes to each row (columns s, s + Sr, ...); the row
// stride ld = Sr (mod 2 Sr) puts the 32 / Sr rows of a warp on distinct
// banks.
struct ChunkClusterLayout {
  int C, W, ld, Sr;
  ColSplit cs;
  long long floats;
};

__host__ __device__ inline ChunkClusterLayout chunk_cluster_layout(int k, int m, int C) {
  ChunkClusterLayout lay;
  lay.C = C;
  lay.W = cdiv(m, C);
  lay.Sr = 1;
  while (lay.Sr < 32 && 2 * lay.Sr * k <= kClusterThreads) lay.Sr *= 2;
  lay.ld = lay.W;
  if (lay.Sr < 32)
    while (lay.ld % (2 * lay.Sr) != lay.Sr) ++lay.ld;
  lay.cs = ogp::col_split(lay.W);
  // two mbarriers; U, P, R slices; p; a, g; the receive buffers (two uses
  // of C rows of k + 1); column partials; s^2
  lay.floats = 4 + 3LL * k * lay.ld + lay.ld + 2LL * k + 2LL * C * (k + 1) +
               2LL * lay.cs.S * lay.cs.CT * 32 + 1;
  return lay;
}

// Pushes, for j < nrows, sum over the block's w columns of X_j . y into slot
// j of exchange use n, where X_j is row j of X (stride ld) for j < self and
// y itself for j == self. Sr lanes share a row (columns s, s + Sr, ..., in
// four accumulators added as (0 + 1) + (2 + 3)), Sr the largest power of
// two up to 32 that keeps nrows rows within the block, at least minSr; the
// lanes are added by shuffles in a fixed order and share the pushes.
__device__ __forceinline__ void row_partials(const float* X, int ld, const float* y, int nrows,
                                             int self, int w, int minSr, const ogp::Exchange& x,
                                             int n) {
  int Sr = minSr;
  while (Sr < 32 && 2 * Sr * nrows <= kClusterThreads) Sr *= 2;
  const int lg = __ffs(Sr) - 1;  // Sr is a power of two: shifts, no divisions
  const int s = threadIdx.x & (Sr - 1);
  const int rows = kClusterThreads >> lg;
  for (int j0 = 0; j0 < nrows; j0 += rows) {
    const int j = j0 + (threadIdx.x >> lg);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < nrows) {
      const float* row = j < self ? X + j * ld : y;
      int l = s;
      for (; l + 3 * Sr < w; l += 4 * Sr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(row[l + c * Sr], y[l + c * Sr], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (l + c * Sr < w) acc[c] = fmaf(row[l + c * Sr], y[l + c * Sr], acc[c]);
    }
    float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    // a butterfly: every lane of the row ends with the same sum, and lane s
    // pushes it to blocks s, s + Sr, ...
    for (int o = Sr >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (j < nrows) ogp::exchange_push(x, n, j, v, s, Sr);
  }
}

// (b) the k-step factor recursion on a cluster of lay.C blocks per output,
// grid (C, Bd). Writes rows 0..k-1 of U, P, R for the block's columns.
__global__ void __launch_bounds__(kClusterThreads)
chunk_recursion_cluster_kernel(const float* __restrict__ p0, float* __restrict__ U,
                               float* __restrict__ Pm, float* __restrict__ R, int k, int m,
                               ChunkClusterLayout lay) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = lay.C, ld = lay.ld;
  const ColSplit cs = lay.cs;
  const int rank = static_cast<int>(cluster.block_rank());
  // two mbarriers, then k x ld slices of this block's columns of U, P, R
  const ogp::Exchange x{reinterpret_cast<unsigned long long*>(sh), sh + 4 + 3 * k * ld + ld + 2 * k,
                        C, k + 1, rank};
  float* Us = sh + 4;
  float* Ps = Us + k * ld;
  float* Rs = Ps + k * ld;
  float* q = Rs + k * ld;                        // ld: the raw row p0[t], then p
  float* a = q + ld;                             // k
  float* g = a + k;                              // k: U p, unscaled
  float* red = x.recv + 2 * C * (k + 1);         // 2 S CT 32: column partials
  float* s2_sh = red + 2 * cs.S * cs.CT * 32;
  const int tid = threadIdx.x;
  const ColTask task = ogp::col_task(cs);
  const int c0 = rank * lay.W;
  const int w = max(0, min(lay.W, m - c0));
  const long long mm = m;
  const long long off = blockIdx.y * k * mm + c0;
  const float* p0b = p0 + off;
  float* Ub = U + off;
  float* Pb = Pm + off;
  float* Rb = R + off;
  ogp::exchange_init(x);

  float next[kClusterRegs];  // p0[t + 1] for this thread's columns
#pragma unroll
  for (int i = 0; i < kClusterRegs; ++i) {
    const int l = tid + i * kClusterThreads;
    next[i] = l < w ? p0b[l] : 0.f;
  }
  for (int t = 0; t < k; ++t) {
    OGP_STAMP(k, t, 0);
#pragma unroll
    for (int i = 0; i < kClusterRegs; ++i) {
      const int l = tid + i * kClusterThreads;
      if (l < w) q[l] = next[i];
      if (l < w && t + 1 < k) next[i] = p0b[(t + 1) * mm + l];
    }
    __syncthreads();
    OGP_STAMP(k, t, 1);
    // 1. a_j = P_j . p0_t for j < t: exchange use 2 t
    ogp::exchange_expect(x, 2 * t, t);
    row_partials(Ps, ld, q, t, t, w, lay.Sr, x, 2 * t);
    OGP_STAMP(k, t, 2);
    ogp::exchange_wait(x, 2 * t);
    OGP_STAMP(k, t, 3);
    for (int j = tid; j < t; j += kClusterThreads) a[j] = ogp::exchange_sum(x, 2 * t, j);
    __syncthreads();
    OGP_STAMP(k, t, 4);
    // 2. p = p0_t + U^T a; U p and |p|^2: exchange use 2 t + 1
    col_partials<1>(Us, nullptr, ld, a, 1.f, t, w, cs, task, red);
    for (int l = tid; l < w; l += kClusterThreads) q[l] += col_sum(red, 0, l, cs);
    __syncthreads();
    OGP_STAMP(k, t, 5);
    ogp::exchange_expect(x, 2 * t + 1, t + 1);
    row_partials(Us, ld, q, t + 1, t, w, lay.Sr, x, 2 * t + 1);
    OGP_STAMP(k, t, 6);
    ogp::exchange_wait(x, 2 * t + 1);
    OGP_STAMP(k, t, 7);
    for (int j = tid; j <= t; j += kClusterThreads) {
      const float v = ogp::exchange_sum(x, 2 * t + 1, j);
      if (j < t) {
        g[j] = v;
      } else {
        *s2_sh = v;
      }
    }
    __syncthreads();
    OGP_STAMP(k, t, 8);
    const float s2 = *s2_sh;
    const float s = sqrtf(s2);
    const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
    const float r1 = sqrtf(s2 + 1.f);
    const float c = r1 - 1.f;
    const float d = 1.f / r1 - 1.f;
    // 3. row t: u, d (u + P^T g), c (u + R^T g) with g = (U p) inv_s
    col_partials<2>(Ps, Rs, ld, g, inv_s, t, w, cs, task, red);
    for (int l = tid; l < w; l += kClusterThreads) {
      const float ul = q[l] * inv_s;
      const float pc = d * (ul + col_sum(red, 0, l, cs));
      const float rc = c * (ul + col_sum(red, 1, l, cs));
      Us[t * ld + l] = ul;
      Ps[t * ld + l] = pc;
      Rs[t * ld + l] = rc;
    }
    __syncthreads();  // row t is read at step t + 1, and q is rewritten
    OGP_STAMP(k, t, 9);
  }
  // the slices go to the scratch of the applies once, after the last step
  for (int e = tid; e < k * w; e += kClusterThreads) {
    const int j = e / w, l = e - j * w;
    Ub[j * mm + l] = Us[j * ld + l];
    Pb[j * mm + l] = Ps[j * ld + l];
    Rb[j * mm + l] = Rs[j * ld + l];
  }
  cluster.sync();  // no block leaves while a push to another may be in flight
}

// (b) for Bd outputs: on clusters of C blocks, or one block per output
// when C is 0. Returns a cudaError_t, or ogp::kNoCluster.
int chunk_recursion(const float* p0, float* U, float* Pm, float* R, int Bd, int k, int m, int C,
                    cudaStream_t s) {
  if (C > 0) {
    const ChunkClusterLayout lay = chunk_cluster_layout(k, m, C);
    return ogp::launch_cluster(chunk_recursion_cluster_kernel, C, Bd,
                               lay.floats * static_cast<long long>(sizeof(float)), s, p0, U, Pm,
                               R, k, m, lay);
  }
  const long long smem = (2LL * m + 2LL * k + 32) * static_cast<long long>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_recursion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chunk_recursion_kernel<<<Bd, kRecursionThreads, smem, s>>>(p0, U, Pm, R, k, m);
  return static_cast<int>(cudaGetLastError());
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

// ---- K4 ----

constexpr int kPCols = 8;                       // pass 1: columns per block
constexpr int kPThreads = 512;
constexpr int kPSlots = kPThreads / kPCols;     // row slots: rows i = slot (mod kPSlots)
constexpr int kPWarps = kPThreads / 32;
static_assert(kPCols == 8 && kPWarps % 4 == 0, "rank1_p_kernel's sums assume 4 rows a warp");

// (K4 pass 1) p[b, j] = sum_i B[b, i, j] v[b, i] for the block's kPCols
// columns, over all m rows, and s2[b, x] = the block's sum of p[b, j]^2.
// Lane l takes column l % kPCols; a warp covers 32 / kPCols rows at a time,
// eight rows a thread in flight. grid (column tiles, Bd)
__global__ void __launch_bounds__(kPThreads)
rank1_p_kernel(const float* __restrict__ B, const float* __restrict__ v, float* __restrict__ p,
               float* __restrict__ s2, int m) {
  __shared__ float red[kPWarps][kPCols];
  ogp::pdl_trigger();
  const long long b = blockIdx.y, mm = m;
  const int col = threadIdx.x % kPCols, slot = threadIdx.x / kPCols;
  const int j = blockIdx.x * kPCols + col;
  const float* Bb = B + b * mm * mm;
  const float* vb = v + b * mm;
  float acc = 0.f;
  if (j < m) {
#pragma unroll 8
    for (int i = slot; i < m; i += kPSlots) acc = fmaf(Bb[i * mm + j], vb[i], acc);
  }
  // the row slots of column col, in a fixed order: the warp's four (xor 8,
  // then 16), then the warps' sums in warp order
  acc += __shfl_xor_sync(0xffffffffu, acc, 8);
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < kPCols) red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    // lane l adds warps 4 (l / 8) .. 4 (l / 8) + 3 of column l % 8
    float pj = 0.f;
#pragma unroll
    for (int w = 0; w < kPWarps / 4; ++w) pj += red[(lane / kPCols) * (kPWarps / 4) + w][col];
    pj += __shfl_xor_sync(0xffffffffu, pj, 8);
    pj += __shfl_xor_sync(0xffffffffu, pj, 16);
    if (lane < kPCols && j < m) p[b * mm + j] = pj;
    const float sq = lane < kPCols && j < m ? pj * pj : 0.f;
    float part = 0.f;
    for (int c = 0; c < kPCols; ++c) part += __shfl_sync(0xffffffffu, sq, c);
    if (lane == 0) s2[b * gridDim.x + blockIdx.x] = part;
  }
}

// ---- K5 ----

// A matrix operand of batched_gemm_kernel: element (r, c) of batch z is
// p[(z >> shift) * bs + r * rs + c * cs] (shift 1: one matrix per pair of
// batches, e.g. per output where the batch runs over (output, L or B)).
struct MatArg {
  const float* p;
  long long rs, cs, bs;
  int shift;
};

// C[z] = [C[z] +] alpha A[z] B[z] for z = blockIdx.z, C[z] at C + z * c_bs
// with row stride c_rs. grid (N tiles, M tiles, batches)
__global__ void __launch_bounds__(kGemmThreads)
batched_gemm_kernel(int M, int N, int K, MatArg a, MatArg b, float* C, long long c_rs,
                    long long c_bs, float alpha, bool accumulate) {
  const int z = blockIdx.z;
  gemm_tile(M, N, K, a.p + (z >> a.shift) * a.bs, a.rs, a.cs, b.p + (z >> b.shift) * b.bs,
            b.rs, b.cs, C + z * c_bs, c_rs, alpha, accumulate, blockIdx.y * kTileM,
            blockIdx.x * kTileN);
}

cudaError_t gemm(int M, int N, int K, MatArg a, MatArg b, float* C, long long c_rs,
                 long long c_bs, int batches, float alpha, bool accumulate, cudaStream_t s) {
  dim3 grid(cdiv(N, kTileN), cdiv(M, kTileM), batches);
  batched_gemm_kernel<<<grid, kGemmThreads, 0, s>>>(M, N, K, a, b, C, c_rs, c_bs, alpha,
                                                     accumulate);
  return cudaGetLastError();
}

constexpr int kCoordThreads = 1024;

// (K5 coord) the k-step recursion on coordinates, one block per output.
// M: (Bd, k, k) = P0 P0^T; writes Ut (Bd, k, k) and Z (Bd, 2, k, k) with
// Z[b, 0] = Rt, Z[b, 1] = Pt. Rows < t are read at step t and row t is
// written, so nothing needs zeroing: the columns > t of row t come out 0.
__global__ void __launch_bounds__(kCoordThreads)
coord_recursion_kernel(const float* __restrict__ Mg, float* __restrict__ Ug,
                       float* __restrict__ Z, int k) {
  extern __shared__ float sh[];
  const long long kk = (long long)k * k;
  float* M = sh;              // k x k
  float* Ut = M + kk;         // k x k
  float* Pt = Ut + kk;        // k x k
  float* a = Pt + kk;         // k
  float* g = a + k;           // k
  float* pi = g + k;          // k
  float* mpi = pi + k;        // k
  float* alpha = mpi + k;     // k
  float* malpha = alpha + k;  // k
  float* red = malpha + k;    // 32
  const long long b = blockIdx.x;
  float* Rt = Z + b * 2 * kk;  // in device memory: column l only by thread l
  float* Pg = Rt + kk;
  float* Ub = Ug + b * kk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (long long e = threadIdx.x; e < kk; e += blockDim.x) M[e] = Mg[b * kk + e];
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    // a_j = Pt_j . M_t for j < t, one warp per row
    const float* mt = M + t * k;
    for (int j = warp; j < t; j += nwarps) {
      float s = 0.f;
      for (int l = lane; l < k; l += 32) s = fmaf(Pt[j * k + l], mt[l], s);
      s = warp_sum(s);
      if (lane == 0) a[j] = s;
    }
    __syncthreads();
    // pi = e_t + Ut^T a
    if (threadIdx.x < k) {
      const int l = threadIdx.x;
      float v = l == t ? 1.f : 0.f;
      for (int j = 0; j < t; ++j) v = fmaf(Ut[j * k + l], a[j], v);
      pi[l] = v;
    }
    __syncthreads();
    // mpi = M pi, one warp per row
    for (int j = warp; j < k; j += nwarps) {
      float s = 0.f;
      for (int l = lane; l < k; l += 32) s = fmaf(M[j * k + l], pi[l], s);
      s = warp_sum(s);
      if (lane == 0) mpi[j] = s;
    }
    __syncthreads();
    float s2 = threadIdx.x < k ? pi[threadIdx.x] * mpi[threadIdx.x] : 0.f;
    s2 = fmaxf(block_sum(s2, red), 0.f);
    const float s = sqrtf(s2);
    const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
    const float r1 = sqrtf(s2 + 1.f);
    const float c = r1 - 1.f;
    const float d = 1.f / r1 - 1.f;
    if (threadIdx.x < k) {
      alpha[threadIdx.x] = pi[threadIdx.x] * inv_s;
      malpha[threadIdx.x] = mpi[threadIdx.x] * inv_s;
    }
    __syncthreads();
    // g_j = Ut_j . (M alpha) for j < t
    for (int j = warp; j < t; j += nwarps) {
      float sg = 0.f;
      for (int l = lane; l < k; l += 32) sg = fmaf(Ut[j * k + l], malpha[l], sg);
      sg = warp_sum(sg);
      if (lane == 0) g[j] = sg;
    }
    __syncthreads();
    // row t: alpha, d (alpha + Pt^T g), c (alpha + Rt^T g)
    if (threadIdx.x < k) {
      const int l = threadIdx.x;
      const float al = alpha[l];
      float pc = al, rc = al;
      for (int j = 0; j < t; ++j) {
        pc = fmaf(Pt[j * k + l], g[j], pc);
        rc = fmaf(Rt[j * k + l], g[j], rc);
      }
      Ut[t * k + l] = al;
      Pt[t * k + l] = d * pc;
      Rt[t * k + l] = c * rc;
      Ub[t * k + l] = al;
      Pg[t * k + l] = d * pc;
    }
    __syncthreads();  // row t is read by every warp at step t + 1
  }
}

}  // namespace

extern "C" {

// K2. L, B: (Bd, m, m), updated in place; p: (Bd, m); s2: (Bd,) scratch.
// Returns cudaGetLastError() after the launches.
int ogp_rank1_apply(float* L, float* B, const float* p, float* s2, int Bd, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rank1_prepass_kernel<<<Bd, 256, 0, s>>>(p, s2, m);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(rank1_rows(L, B, nullptr, nullptr, p, s2, 1, Bd, m, false, s));
}

// Dynamic shared memory of the single-block K1 recursion kernel, in bytes.
long long ogp_blocked_chunk_smem(int k, int m) {
  return (2LL * m + 2LL * k + 32) * static_cast<long long>(sizeof(float));
}

// Dynamic shared memory of one block of the cluster recursion, in bytes.
long long ogp_chunk_cluster_smem(int k, int m, int C) {
  return chunk_cluster_layout(k, m, C).floats * static_cast<long long>(sizeof(float));
}

// K1. L, B: (Bd, m, m), updated in place; idx: (k, P) int32, shared by the
// outputs; wv: (Bd, k, P); p0, U, Pm, R: (Bd, k, m) scratch; T: (Bd, 2, m, k)
// scratch. The recursion runs on clusters of C blocks, or one block per
// output when C is 0. Returns cudaGetLastError() after the launches, or -1
// when no cluster of C blocks fits on the card.
int ogp_blocked_chunk(float* L, float* B, const int* idx, const float* wv, float* p0,
                      float* U, float* Pm, float* R, float* T, int Bd, int k, int P, int m,
                      int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(B, idx, wv, p0, k, P, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = chunk_recursion(p0, U, Pm, R, Bd, k, m, C, s);
  if (rc != 0) return rc;

  chunk_apply_t_kernel<<<dim3(cdiv(k, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, R, Pm, T, k, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_apply_x_kernel<<<dim3(cdiv(m, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, T, U, k, m);
  return static_cast<int>(cudaGetLastError());
}

// Column tiles of K4's pass 1: the |p|^2 partials are (Bd, tiles).
int ogp_rank1_update_tiles(int m) { return cdiv(m, kPCols); }

// K4. L, B: (Bd, m, m), updated in place; A: (Bd, m, m), updated in place,
// or null (slim); v: (Bd, m); p: (Bd, m) and s2: (Bd, tiles) scratch.
// Returns cudaGetLastError() after the launches.
int ogp_rank1_update(float* L, float* B, float* A, const float* v, float* p, float* s2, int Bd,
                     int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ogp_rank1_update_tiles(m);
  rank1_p_kernel<<<dim3(tiles, Bd), kPThreads, 0, s>>>(B, v, p, s2, m);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(rank1_rows(L, B, A, v, p, s2, tiles, Bd, m, true, s));
}

// K5 sub. L, B: (Bd, m, m), updated in place; idx: (k, P) int32; wv:
// (nb, Bd, sub, P) with nb = k / sub; q, U, Pm, R: (nb, Bd, sub, m) scratch;
// a2: (Bd, sub, sub) and T: (Bd, 2, m, sub) scratch. Each sub-block's
// recursion runs on clusters of C blocks (C = 0: one block per output).
int ogp_blocked_chunk_sub(float* L, float* B, const int* idx, const float* wv, float* q,
                          float* U, float* Pm, float* R, float* a2, float* T, int Bd, int k,
                          int sub, int P, int m, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = k / sub;
  const long long mm = m, rows = (long long)sub * m, blk = Bd * rows;
  cudaError_t e;
  // every sub-block's raw rows come from B before the chunk changes it
  for (int j = 0; j < nb; ++j) {
    chunk_gather_kernel<<<dim3(sub, Bd), 256, 0, s>>>(B, idx + (long long)j * sub * P,
                                                      wv + (long long)j * Bd * sub * P,
                                                      q + j * blk, sub, P, m);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int j = 0; j < nb; ++j) {
    float* qj = q + j * blk;
    for (int i = 0; i < j; ++i) {
      // a2 = q_j P_i^T, then q_j += a2 U_i
      e = gemm(sub, sub, m, MatArg{qj, mm, 1, rows, 0}, MatArg{Pm + i * blk, 1, mm, rows, 0}, a2,
               sub, (long long)sub * sub, Bd, 1.f, false, s);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = gemm(sub, m, sub, MatArg{a2, sub, 1, (long long)sub * sub, 0},
               MatArg{U + i * blk, mm, 1, rows, 0}, qj, mm, rows, Bd, 1.f, true, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int rc = chunk_recursion(qj, U + j * blk, Pm + j * blk, R + j * blk, Bd, sub, m, C, s);
    if (rc != 0) return rc;
  }
  for (int j = 0; j < nb; ++j) {
    chunk_apply_t_kernel<<<dim3(cdiv(sub, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0,
                           s>>>(L, B, R + j * blk, Pm + j * blk, T, sub, m);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    chunk_apply_x_kernel<<<dim3(cdiv(m, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0,
                           s>>>(L, B, T, U + j * blk, sub, m);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Dynamic shared memory of the K5 coord recursion kernel, in bytes.
long long ogp_blocked_chunk_coord_smem(int k) {
  return (3LL * k * k + 6LL * k + 32) * static_cast<long long>(sizeof(float));
}

// K5 coord. L, B: (Bd, m, m), updated in place; idx: (k, P) int32; wv:
// (Bd, k, P); p0: (Bd, k, m), Mg, Ut: (Bd, k, k), Z, Tc: (Bd, 2, k, k),
// X1, X2: (Bd, 2, m, k) scratch.
int ogp_blocked_chunk_coord(float* L, float* B, const int* idx, const float* wv, float* p0,
                            float* Mg, float* Ut, float* Z, float* Tc, float* X1, float* X2,
                            int Bd, int k, int P, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mm = m, km = (long long)k * m, kk = (long long)k * k;
  chunk_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(B, idx, wv, p0, k, P, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // M = P0 P0^T
  e = gemm(k, k, m, MatArg{p0, mm, 1, km, 0}, MatArg{p0, 1, mm, km, 0}, Mg, k, kk, Bd, 1.f,
           false, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long smem = ogp_blocked_chunk_coord_smem(k);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(coord_recursion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  coord_recursion_kernel<<<Bd, kCoordThreads, smem, s>>>(Mg, Ut, Z, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // Tc[b, w] = Z[b, w]^T Ut[b]: Rt^T Ut for L, Pt^T Ut for B
  e = gemm(k, k, k, MatArg{Z, 1, k, kk, 0}, MatArg{Ut, k, 1, kk, 1}, Tc, k, kk, 2 * Bd, 1.f,
           false, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // X1[b, w] = X_w P0^T (K1's apply with R = P = P0)
  chunk_apply_t_kernel<<<dim3(cdiv(k, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, p0, p0, X1, k, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // X2[b, w] = X1[b, w] Tc[b, w]
  e = gemm(m, k, k, MatArg{X1, k, 1, km, 0}, MatArg{Tc, k, 1, kk, 0}, X2, k, km, 2 * Bd, 1.f,
           false, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // X_w += X2[b, w] P0 (K1's apply with U = P0)
  chunk_apply_x_kernel<<<dim3(cdiv(m, kTileN), cdiv(m, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, X2, p0, k, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
