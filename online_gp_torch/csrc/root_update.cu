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
//       us; an exchange's wait is 0.04-0.2 us.
//       That is the step the grid and spread kernels (below) and K5 sub's
//       fused kernel run. Every recursion on one cluster (a flat chunk at
//       m <= 1,120, k = 128, and K5 sub's sub-blocks run one at a time)
//       runs chunk_recursion_carried_kernel, on the same layout, with one
//       exchange a step: the dots a_j = P_j . p0_t are carried in the raw
//       rows themselves. Each raw row waits in its row of U's slice and
//       after step t holds r = p0_{t'} + sum_{j<=t} (P_j . p0_{t'}) U_j, so
//       it is p when its step comes (no stage 1, no p0 row read). Dotting
//       P_t = d (u_t + sum_{j<t} g_j P_j) with p0_{t'} gives
//       P_t . p0_{t'} = d inv_s (r . p): the step's one row pass over all k
//       rows against p carries U_j . p (j < t), |p|^2 and r . p (t' > t),
//       and the later rows take r += (d inv_s r . p) u_t within the block.
//       Shapes whose slice does not
//       fit a block of one cluster (3 k ld floats, the receive buffers and
//       the vectors over 227 KB at C = 8: m > 1,120 at k = 128) spread
//       their columns over G clusters of 8 (chunk_recursion_grid_kernel,
//       W = cdiv(m, 8 G), the smallest G up to 8 whose slice fits: G = 4 at
//       m = 4,096, k = 128, 32 SMs an output, where one block read U, P, R
//       from L2 at one SM's rate before). Each exchange is then summed in
//       two levels, within the cluster as above and across the G clusters
//       through device memory (ogp::GridExchange, common.cuh): block 0 of
//       each cluster writes its cluster's sums with their use's tag, every
//       block waits for the G tags and adds the sums in cluster order.
//       The clusters of one output wait on each other, so a launch holds no
//       more outputs than the card runs at once (cudaOccupancyMaxActiveClusters,
//       read by the wrapper, which launches in waves). Past G = 8 (m > 8,960
//       at k = 128), or where the card cannot hold the G clusters, the
//       recursion is spread over the card (chunk_recursion_spread_kernel):
//       as many clusters of 8 as the card holds at once, up to 16 (15 on an
//       H100 SXM, 120 SMs an output), the sums in the same two levels, each
//       block keeping in shared memory its slices of U, P and R where they
//       fit (m <= ~16,800 at k = 128), else of U alone (P and R, 2 k m
//       floats, read and written in the outputs, from L2 where they fit:
//       33 MB at m = 32,400), else none. What bounds it: the two exchanges
//       a step (latency) and, with slices in device memory, each step's
//       passes over t of their rows from L2 at 120 SMs' rate, not one
//       SM's.
//       The rule is by shape and the card's capacity: chunk_cluster_plan
//       and chunk_spread_plan in online_gp_torch/ops/cuda_root_update.py,
//       mirroring chunk_cluster_layout below (the wrapper checks the two
//       agree).
//   (c) apply: X += (X A^T) U for (X, A) = (L, R) and (B, P), 4 m^2 k
//       multiply-adds in all, bound by operations (8 m^2 k flops against
//       4 m^2 floats of L and B in and out: 0.26 ms of f32 FMA at m = 4,096
//       on an H100, 0.09 ms of bytes). One launch on thread-block clusters
//       (chunk_apply_cluster_kernel) replaces the port's first design, two
//       tiled GEMMs (T = X A^T into device memory, then X += T U; 64 x 64
//       tiles, 4 x 4 outputs a thread, scalar loads): a cluster of C = 8
//       blocks owns a 64-row tile of one X, block r its columns [r W,
//       r W + W), W = cdiv(m, C) rounded up to 4. The block forms its
//       partial T_r = X_slice A_slice^T (64 x k) in registers while its
//       columns of X and of A (transposed on the way in) stream through a
//       three-slot cp.async ring, adds the C partials in rank order over
//       DSMEM (cluster_reduce, float4), then X_slice += T U_slice with U
//       streaming through the same ring, reading X again (from L2) as each
//       128-column chunk is written: T never leaves shared memory, one
//       launch where there were two. What bounds it on this card: shared
//       memory and register banks before FMAs. A warp's 16-byte shared
//       load of distinct addresses takes 4 cycles of the SM's 128 bytes a
//       cycle and feeds 4 FMAs a thread, so each thread owns 4 x 8
//       outputs, one factor broadcast along the sum's index (X's, T's) and
//       the other across its 8 columns (A^T's, U's): the 8 values then sit
//       in registers of alternating parity, and each accumulator can take
//       the bank its other operand does not (with both factors loaded
//       along the sum's index, every FMA's two multiplicands share a
//       parity).
//       64-row tiles keep a block at 112 KB of shared memory and 128
//       registers a thread, so two blocks share an SM and twice as many
//       clusters run at once as with one block a SM (at 128-row tiles m =
//       900 took two waves); one block's reduce and epilogue then overlap
//       the other's FMAs. Holding the X slice in shared memory instead (X
//       read once) does not leave room for two blocks at m = 4,096. True
//       f32 FMA, no atomics: a second call is bitwise the same. Shapes
//       whose T does not fit one block beside the ring (k > 544;
//       chunk_apply_plan in ops/cuda_root_update.py, by shape, mirroring
//       chunk_apply_layout below) run the tiled kernels instead
//       (chunk_apply_t_kernel, chunk_apply_x_kernel on ogp::gemm_tile). X
//       is updated in place: each block writes only its own slice, after it
//       has read it.
//   The three stages are also C entries of their own (ogp_chunk_gather_rows,
//   ogp_chunk_factors, ogp_chunk_apply_rows) for roots row-sharded over
//   processes: the gather and the apply then run over a shard's rows
//   [row0, row0 + rows) of L and B, the recursion on the p0 summed across
//   the shards (the JAX package's sharded_stream_blocked in
//   online_gp_tpu/parallel/mesh.py runs the plain recursion there).
// Bound: operations, 8 m^2 k + 5 k^2 m flops per output (0.9 GFLOP at
// m = 900, k = 128) against 4 m^2 floats of L and B traffic. The recursion
// is bound by latency on this card: at t = 64 on one cluster at m = 900
// the step above was ~4.6 us of short stages (row and column passes over
// ~36 K floats of shared memory per block, two exchanges, six block
// barriers), each a chain of dependent shared-memory loads and shuffles;
// the carried kernel's is ~3.4 us at m = 900 (~2.5 us at m = 256): one
// exchange, three barriers, its row pass, P and R partials and rank-1
// update each 0.65-1 us. One block an output would read U, P, R
// from L2 at one SM's rate (~75 GB/s on an H100, 16.5 us a step at
// t = 64). cluster_probe.py measures the split, building this file with
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
// not cover, the same k exact sequential rank-1 updates, each differing from
// the Pallas kernel only by fp reassociation.
// Bound: operations, as K1: the apply's 8 m^2 k flops per output dominate
// (0.83 GFLOP at m = 900, k = 128); both recursions are bound by latency.
//   sub (sub < k; body _fused_chunk_kernel_batched): the flat recursion runs
//       inside sub-blocks of `sub` rows, so a step reads at most `sub` rows
//       of U, P, R instead of t. The Pallas kernel corrects each sub-block's
//       rows by the earlier ones with two small GEMMs per pair and applies
//       the sub-blocks one at a time; as its own launches that was 12 GEMMs
//       of one 64 x 64 tile each walking all m columns, and four applies
//       each reading and writing all of L and B. Here the product of the
//       sub-block operators is collapsed into one rank-k operator,
//       G_0 ... G_{nb-1} = I + Rc^T U with Rc_j = R_j + (R_j U_{<j}^T) Rc_{<j}
//       (and Pc with P), so one cluster kernel (chunk_sub_cluster_kernel)
//       runs the whole two-level recursion on K1's layout, and so on every
//       shape K1's one-cluster plan takes: each sub-block's local steps are
//       K1's two-exchange cluster step on its own rows; at a boundary the
//       collapse of its rows, then the next sub-block's one-step correction
//       q += (q Pc_{<j+1}^T) U_{<j+1}, each a block of dots summed across
//       the cluster (register-tiled over the block's columns, cluster_reduce
//       through the step's buffers, which a boundary does not use, in rounds
//       of rows as they fit) and a row update. Then K1's gather once and
//       K1's apply once, at rank k. The boundaries' dots and updates are
//       small GEMMs bound by shared-memory loads and latency; they take what
//       the shorter local steps save, so sub costs about what flat K1 does.
//       Shapes past K1's one-cluster plan (m > 1,120 at k = 128) run one
//       sub-block at a time (ogp_blocked_chunk_sub, each recursion on K1's
//       route at k = sub: the carried kernel where one cluster holds it).
//   coord (body _fused_chunk_kernel_coord): every factor row lies in the span
//       of the chunk's raw rows p0, so the recursion runs on k-dim
//       coordinates (u_t = Ut_t P0, p_t = Pt_t P0, r_t = Rt_t P0). Ut, Pt and
//       Rt are lower triangular; the Pallas kernel takes the step's inner
//       products through M = P0 P0^T, five dependent passes a step. Here
//       the kernel carries them instead, W = (u_i . u_j), Y = (u_j . p0_l)
//       and Q = (p_j . p0_l), each new row a by-product of the step, so a
//       step is two passes between two block barriers; all six triangles
//       (3 k^2 + 3 k + 32 floats with the vectors: every k up to 138 fits,
//       as it did when the kernel kept M, Ut and Pt whole) sit in shared
//       memory, and M's column for
//       the next step is loaded during the step. M itself comes from a
//       split-K Gram kernel over the lower triangle. The apply rebuilds the
//       flat factors, (U, R, P) = (Ut, Rt, Pt) P0 in one batched GEMM, and
//       runs K1's apply once: the same flops as the Pallas association
//       X += ((X P0^T)(Rt^T Ut)) P0.
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
using ogp::kClusterWarps;
using ogp::kGemmThreads;
using ogp::kTileM;
using ogp::kTileN;
using ogp::warp_sum;
namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerBlock = 8;  // K2: one warp per row
constexpr int kRowRegs = 32;      // K2: a row's entries per lane held in registers

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
// version's A + v v^T (product, then sum). L and B hold `rows` rows of m
// columns per output: rows = m for the whole roots (K2, K4), fewer for a
// row shard (K2's row-shard entry), whose p is the whole (all-reduced)
// B^T v; each row's update needs its own entries and p only. A and v only
// at rows = m. |p|^2 is the sum of the nparts
// partials s2[b, :] (lane l adds l, l + 32, ... in turn, then a fixed
// butterfly: every warp gets the same value); then s = |p|, u = p/s (u = 0
// when s <= 1e-20, the Pallas guard), c = sqrt(s^2 + 1) - 1,
// d = 1/sqrt(s^2 + 1) - 1. The A rows read nothing the kernel before
// wrote, so they run before its pdl_wait().
__global__ void __launch_bounds__(kRowsPerBlock * 32)
rank1_rows_kernel(float* L, float* B, float* A, const float* __restrict__ v,
                  const float* __restrict__ p, const float* __restrict__ s2, int nparts, int rows,
                  int m) {
  const long long b = blockIdx.y, mm = m, rr = rows;
  const int which = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= rows) return;  // whole warps leave; no block-wide sync below
  if (which == 2) {
    float* row = A + b * rr * mm + i * mm;
    const float* vb = v + b * mm;
    const float vi = vb[i];
    for (int l = lane; l < m; l += 32) row[l] = __fadd_rn(row[l], __fmul_rn(vi, vb[l]));
    return;
  }
  ogp::pdl_wait();
  // the row's dot with p first: its loads do not wait on the scalars. Up to
  // m = 32 kRowRegs the warp keeps its row and p in registers, every load
  // in flight at once, and reads the row once (the column count decides,
  // not the rows).
  float* row = (which == 0 ? L : B) + b * rr * mm + i * mm;
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

// The row pass of K2 and K4 over `rows` rows of each output; A and v only
// for K4's full variant (else null), at rows = m.
cudaError_t rank1_rows(float* L, float* B, float* A, const float* v, const float* p,
                       const float* s2, int nparts, int Bd, int rows, int m, bool pdl, cudaStream_t s) {
  return ogp::launch(rank1_rows_kernel, dim3(cdiv(rows, kRowsPerBlock), Bd, A ? 3 : 2),
                     dim3(kRowsPerBlock * 32), 0, s, pdl, L, B, A, v, p, s2, nparts, rows, m);
}

// (a) p0[b, t, :] = sum_p wv[b, t, p] * B[b, idx[t, p] - row0, :] over the
// stencil points in [row0, row0 + rows): B holds those rows of each output,
// (Bd, rows, m); the whole chunk has row0 = 0, rows = m. grid (k, Bd)
__global__ void chunk_gather_kernel(const float* __restrict__ B, const int* __restrict__ idx,
                                    const float* __restrict__ wv, float* __restrict__ p0,
                                    int k, int P, int rows, int m, int row0) {
  const long long t = blockIdx.x, b = blockIdx.y, mm = m;
  const float* Bb = B + b * rows * mm;
  const int* it = idx + t * P;
  const float* wt = wv + (b * k + t) * P;
  float* out = p0 + (b * k + t) * mm;
  for (int l = threadIdx.x; l < m; l += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) {
      const int row = it[q] - row0;
      if ((unsigned)row < (unsigned)rows) acc = fmaf(wt[q], Bb[row * mm + l], acc);
    }
    out[l] = acc;
  }
}

// Shared-memory layout of one block of the cluster recursions, K1's and
// K5 sub's; chunk_cluster_plan (online_gp_torch/ops/cuda_root_update.py)
// mirrors it.
// A row pass gives Sr lanes to each row (columns s, s + Sr, ...); the row
// stride ld = Sr (mod 2 Sr) puts the 32 / Sr rows of a warp on distinct
// banks.
struct ChunkClusterLayout {
  int C, W, ld, Sr;
  ColSplit cs;
  long long floats;
};

// On G clusters of C blocks per output (G > 1: chunk_recursion_grid_kernel
// and chunk_recursion_spread_kernel) a block owns W = cdiv(m, C G) columns;
// its receive buffers stay those of its own cluster's C blocks. `slices` of
// the factor rows sit in shared memory: 3 (U, P, R), or, in the spread
// kernel, 1 (U; P and R in device memory) or 0 (all three there).
__host__ __device__ inline ChunkClusterLayout chunk_cluster_layout(int k, int m, int C, int G = 1, int slices = 3) {
  ChunkClusterLayout lay;
  lay.C = C;
  lay.W = cdiv(m, C * G);
  lay.Sr = 1;
  while (lay.Sr < 32 && 2 * lay.Sr * k <= kClusterThreads) lay.Sr *= 2;
  lay.ld = lay.W;
  if (lay.Sr < 32)
    while (lay.ld % (2 * lay.Sr) != lay.Sr) ++lay.ld;
  lay.cs = ogp::col_split(lay.W);
  // two mbarriers; U, P, R slices (those in shared memory); p; a, g; the
  // receive buffers (two uses of C rows of k + 1); column partials; s^2
  lay.floats = 4 + static_cast<long long>(slices) * k * lay.ld + lay.ld + 2LL * k + 2LL * C * (k + 1) +
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

// What one block of K5 sub's cluster kernel works on: its slices and
// buffers (chunk_cluster_layout, whose offsets K1's kernel spells out
// itself) and its columns [c0, c0 + w) of the output. The
// buffers from q to the end of the layout (q, a, g, the receive buffers,
// the column partials, s^2) serve only a step, so K5 sub's sub-block
// boundaries sum their coefficients there (bnd, nbnd floats).
struct ClusterBlock {
  ogp::Exchange x;
  float *Us, *Ps, *Rs, *q, *a, *g, *red, *s2, *bnd;
  int ld, w, Sr, nbnd;
  ColSplit cs;
  ColTask task;
  long long off;  // of the block's first column in a (Bd, k, m) array
};

__device__ __forceinline__ ClusterBlock cluster_block(float* sh, int k, int m, int rank,
                                                      const ChunkClusterLayout& lay) {
  ClusterBlock cb;
  const int C = lay.C, ld = lay.ld;
  // two mbarriers, then k x ld slices of this block's columns of U, P, R
  cb.Us = sh + 4;
  cb.Ps = cb.Us + k * ld;
  cb.Rs = cb.Ps + k * ld;
  cb.q = cb.Rs + k * ld;  // ld: the step's input row, then p
  cb.a = cb.q + ld;       // k
  cb.g = cb.a + k;        // k: U p, unscaled
  cb.x = ogp::Exchange{reinterpret_cast<unsigned long long*>(sh), cb.g + k, C, k + 1, rank};
  cb.red = cb.x.recv + 2 * C * (k + 1);  // 2 S CT 32: column partials
  cb.s2 = cb.red + 2 * lay.cs.S * lay.cs.CT * 32;
  cb.bnd = cb.q;
  cb.nbnd = static_cast<int>(lay.floats - (cb.q - sh));
  cb.ld = ld;
  cb.Sr = lay.Sr;
  cb.cs = lay.cs;
  cb.task = ogp::col_task(lay.cs);
  const int c0 = rank * lay.W;
  cb.w = max(0, min(lay.W, m - c0));
  cb.off = blockIdx.y * static_cast<long long>(k) * m + c0;
  return cb;
}

// One step of K1's cluster recursion, as K5 sub runs it on the t rows of
// its sub-block's slices at U0, P0, R0 (rows of stride cb.ld), the step's
// input row already in cb.q (and visible to the block): writes row t of
// each. Exchange uses 2 n and 2 n + 1; stamps as step ts of k. K1's grid
// and spread kernels keep a copy of this body in
// chunk_recursion_cluster_body: a change to one is a change to both.
__device__ __forceinline__ void cluster_step(const ClusterBlock& cb, float* U0, float* P0, float* R0,
                                             int t, int n, int k, int ts) {
  const int tid = threadIdx.x, ld = cb.ld, w = cb.w;
  float* q = cb.q;
  (void)k;
  (void)ts;
  // 1. a_j = P_j . p0_t for j < t: exchange use 2 n
  ogp::exchange_expect(cb.x, 2 * n, t);
  row_partials(P0, ld, q, t, t, w, cb.Sr, cb.x, 2 * n);
  OGP_STAMP(k, ts, 2);
  ogp::exchange_wait(cb.x, 2 * n);
  OGP_STAMP(k, ts, 3);
  for (int j = tid; j < t; j += kClusterThreads) cb.a[j] = ogp::exchange_sum(cb.x, 2 * n, j);
  __syncthreads();
  OGP_STAMP(k, ts, 4);
  // 2. p = p0_t + U^T a; U p and |p|^2: exchange use 2 n + 1
  col_partials<1>(U0, nullptr, ld, cb.a, 1.f, t, w, cb.cs, cb.task, cb.red);
  for (int l = tid; l < w; l += kClusterThreads) q[l] += col_sum(cb.red, 0, l, cb.cs);
  __syncthreads();
  OGP_STAMP(k, ts, 5);
  ogp::exchange_expect(cb.x, 2 * n + 1, t + 1);
  row_partials(U0, ld, q, t + 1, t, w, cb.Sr, cb.x, 2 * n + 1);
  OGP_STAMP(k, ts, 6);
  ogp::exchange_wait(cb.x, 2 * n + 1);
  OGP_STAMP(k, ts, 7);
  for (int j = tid; j <= t; j += kClusterThreads) {
    const float v = ogp::exchange_sum(cb.x, 2 * n + 1, j);
    if (j < t) {
      cb.g[j] = v;
    } else {
      *cb.s2 = v;
    }
  }
  __syncthreads();
  OGP_STAMP(k, ts, 8);
  const float s2 = *cb.s2;
  const float s = sqrtf(s2);
  const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
  const float r1 = sqrtf(s2 + 1.f);
  const float c = r1 - 1.f;
  const float d = 1.f / r1 - 1.f;
  // 3. row t: u, d (u + P^T g), c (u + R^T g) with g = (U p) inv_s
  col_partials<2>(P0, R0, ld, cb.g, inv_s, t, w, cb.cs, cb.task, cb.red);
  for (int l = tid; l < w; l += kClusterThreads) {
    const float ul = q[l] * inv_s;
    const float pc = d * (ul + col_sum(cb.red, 0, l, cb.cs));
    const float rc = c * (ul + col_sum(cb.red, 1, l, cb.cs));
    U0[t * ld + l] = ul;
    P0[t * ld + l] = pc;
    R0[t * ld + l] = rc;
  }
  __syncthreads();  // row t is read at step t + 1, and q is rewritten
  OGP_STAMP(k, ts, 9);
}

// The slices go to the scratch of the applies once, after the last step.
__device__ __forceinline__ void cluster_store(const ClusterBlock& cb, float* U, float* Pm, float* R,
                                              int k, int m) {
  const long long mm = m;
  for (int e = threadIdx.x; e < k * cb.w; e += kClusterThreads) {
    const int j = e / cb.w, l = e - j * cb.w;
    U[cb.off + j * mm + l] = cb.Us[j * cb.ld + l];
    Pm[cb.off + j * mm + l] = cb.Ps[j * cb.ld + l];
    R[cb.off + j * mm + l] = cb.Rs[j * cb.ld + l];
  }
}

// (b) the k-step factor recursion on gx.G clusters of lay.C blocks per
// output, grid (C G, Bd): the grid and spread kernels' body. The sums of
// each exchange are added within the cluster, then across the clusters
// (GridExchange; stamps 10 and 11 of step t close the two cross-cluster
// sums). Writes rows 0..k-1 of U, P, R for the block's columns. Its step is
// a copy of cluster_step's body (K5 sub's), and its pointers spell out
// chunk_cluster_layout as cluster_block does, each kept in step with the
// other: through the shared step the compiler spilled registers and the
// recursion took 9% longer on an H100, and through cluster_block 1.5%
// longer. kSlices < 3 (the spread kernel only) keeps P and R (and U, at 0)
// in device memory, in the rows of the outputs Pm and R (U) that the step
// writes anyway: a block reads and writes only its own columns there, so
// __syncthreads() orders a row's writes before the next step's reads. Rows
// in device memory are summed by row_partials with 8 lanes or more a row
// (32 contiguous bytes a load), rows in shared memory with lay.Sr.
template <int kSlices, int kMaxG>
__device__ __forceinline__ void chunk_recursion_cluster_body(const float* __restrict__ p0, float* __restrict__ U,
                                                             float* __restrict__ Pm, float* __restrict__ R,
                                                             int k, int m, const ChunkClusterLayout& lay,
                                                             const ogp::GridExchange& gx) {
  static_assert(kSlices == 3 || kSlices == 1 || kSlices == 0, "slices in shared memory: 3, 1 or 0");
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = lay.C, ld = lay.ld;
  const ColSplit cs = lay.cs;
  const int rank = static_cast<int>(cluster.block_rank());
  // two mbarriers, then k x ld slices of this block's columns of U, P, R
  // (those of kSlices)
  const ogp::Exchange x{reinterpret_cast<unsigned long long*>(sh), sh + 4 + kSlices * k * ld + ld + 2 * k,
                        C, k + 1, rank};
  const int tid = threadIdx.x;
  const ColTask task = ogp::col_task(cs);
  const int c0 = (gx.g * C + rank) * lay.W;
  const int w = max(0, min(lay.W, m - c0));
  const long long mm = m;
  const long long off = blockIdx.y * k * mm + c0;
  const float* p0b = p0 + off;
  float* Ub = U + off;
  float* Pb = Pm + off;
  float* Rb = R + off;
  float* Us = kSlices >= 1 ? sh + 4 : Ub;
  float* Ps = kSlices == 3 ? Us + k * ld : Pb;
  float* Rs = kSlices == 3 ? Ps + k * ld : Rb;
  const int ldU = kSlices >= 1 ? ld : m, ldP = kSlices == 3 ? ld : m;
  const int SrU = kSlices >= 1 ? lay.Sr : 8, SrP = kSlices == 3 ? lay.Sr : 8;
  float* q = sh + 4 + kSlices * k * ld;           // ld: the raw row p0[t], then p
  float* a = q + ld;                             // k
  float* g = a + k;                              // k: U p, unscaled
  float* red = x.recv + 2 * C * (k + 1);         // 2 S CT 32: column partials
  float* s2_sh = red + 2 * cs.S * cs.CT * 32;
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
    row_partials(Ps, ldP, q, t, t, w, SrP, x, 2 * t);
    OGP_STAMP(k, t, 2);
    ogp::exchange_wait(x, 2 * t);
    OGP_STAMP(k, t, 3);
    for (int j = tid; j < t; j += kClusterThreads) {
      const float v = ogp::exchange_sum(x, 2 * t, j);
      a[j] = ogp::grid_sum<kMaxG>(gx, 2 * t, j, v);
    }
    OGP_STAMP(k, t, 10);
    __syncthreads();
    OGP_STAMP(k, t, 4);
    // 2. p = p0_t + U^T a; U p and |p|^2: exchange use 2 t + 1
    col_partials<1>(Us, nullptr, ldU, a, 1.f, t, w, cs, task, red);
    for (int l = tid; l < w; l += kClusterThreads) q[l] += col_sum(red, 0, l, cs);
    __syncthreads();
    OGP_STAMP(k, t, 5);
    ogp::exchange_expect(x, 2 * t + 1, t + 1);
    row_partials(Us, ldU, q, t + 1, t, w, SrU, x, 2 * t + 1);
    OGP_STAMP(k, t, 6);
    ogp::exchange_wait(x, 2 * t + 1);
    OGP_STAMP(k, t, 7);
    for (int j = tid; j <= t; j += kClusterThreads) {
      float v = ogp::exchange_sum(x, 2 * t + 1, j);
      v = ogp::grid_sum<kMaxG>(gx, 2 * t + 1, j, v);
      if (j < t) {
        g[j] = v;
      } else {
        *s2_sh = v;
      }
    }
    OGP_STAMP(k, t, 11);
    __syncthreads();
    OGP_STAMP(k, t, 8);
    const float s2 = *s2_sh;
    const float s = sqrtf(s2);
    const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
    const float r1 = sqrtf(s2 + 1.f);
    const float c = r1 - 1.f;
    const float d = 1.f / r1 - 1.f;
    // 3. row t: u, d (u + P^T g), c (u + R^T g) with g = (U p) inv_s
    col_partials<2>(Ps, Rs, ldP, g, inv_s, t, w, cs, task, red);
    for (int l = tid; l < w; l += kClusterThreads) {
      const float ul = q[l] * inv_s;
      const float pc = d * (ul + col_sum(red, 0, l, cs));
      const float rc = c * (ul + col_sum(red, 1, l, cs));
      Us[t * ldU + l] = ul;
      Ps[t * ldP + l] = pc;
      Rs[t * ldP + l] = rc;
    }
    __syncthreads();  // row t is read at step t + 1, and q is rewritten
    OGP_STAMP(k, t, 9);
  }
  // the slices in shared memory go to the scratch of the applies once,
  // after the last step
  if (kSlices > 0) {
    for (int e = tid; e < k * w; e += kClusterThreads) {
      const int j = e / w, l = e - j * w;
      Ub[j * mm + l] = Us[j * ld + l];
      if (kSlices == 3) {
        Pb[j * mm + l] = Ps[j * ld + l];
        Rb[j * mm + l] = Rs[j * ld + l];
      }
    }
  }
  cluster.sync();  // no block leaves while a push to another may be in flight
}

// (b) a flat chunk on one cluster of lay.C blocks per output, grid (C, Bd),
// with one exchange a step: a_j = P_j . p0_t is carried instead of summed
// across the cluster. Each raw row waits in its row of U's slice until its
// step, and after step t every later row r holds p0_{t'} + sum_{j<=t}
// (P_j . p0_{t'}) U_j, so at step t' it is p. The carried dots come from the
// step's own sums: dotting P_t = d (u_t + sum_{j<t} g_j P_j) with p0_{t'}
// and adding the dots of the terms r already holds gives
//     P_t . p0_{t'} = d inv_s (r_{t'} . p),
// so the one row pass over all k rows of the slice against p (row t) gives
// U_j . p (j < t), |p|^2 and r_{t'} . p (t' > t), exchanged together (use
// t) and added in one order in every block; the later rows then take
// r_{t'} += (d inv_s r_{t'} . p) u_t, a rank-1 update within the block.
// Step t:
//   1. the k sums: partials pushed to every block, received, summed (Lx
//      lanes a sum, a fixed butterfly);
//   2. P^T v and R^T v partials over the block's columns (v = U p, g before
//      its scale), the scalars, the rank-1 update of rows t + 1 .. k - 1;
//   3. row t: u = p inv_s, P_t = d (u + inv_s P^T v), R_t = c (u + inv_s R^T v),
//      the column partials' row groups added by a fixed butterfly (Sp lanes
//      a column).
// Three barriers a step where the two-exchange step has six.
// Its column passes take at most kCarriedGroups row groups (fewer partials
// to add for a column). Layout: chunk_cluster_layout's (q and a unused; the
// sums in g's place). U, P, R are the k exact sequential rank-1 updates of
// the other kernels, in float32 with no atomics: only the association
// differs (p's terms added one a step, P^T g scaled after its sum).
constexpr int kCarriedGroups = 8;

__global__ void __launch_bounds__(kClusterThreads)
chunk_recursion_carried_kernel(const float* __restrict__ p0, float* __restrict__ U,
                               float* __restrict__ Pm, float* __restrict__ R, int k, int m,
                               ChunkClusterLayout lay) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = lay.C, ld = lay.ld;
  const ColSplit cs{lay.cs.CT, min(lay.cs.S, kCarriedGroups)};
  const int rank = static_cast<int>(cluster.block_rank());
  // two mbarriers, k x ld slices of U, P, R, q and a (unused), the sums
  float* Us = sh + 4;
  float* Ps = Us + k * ld;
  float* Rs = Ps + k * ld;
  float* v = Rs + k * ld + ld + k;
  const ogp::Exchange x{reinterpret_cast<unsigned long long*>(sh), v + k, C, k + 1, rank};
  float* red = x.recv + 2 * C * (k + 1);  // 2 S CT 32: column partials
  const int tid = threadIdx.x;
  const ColTask task = ogp::col_task(cs);
  int Sp = 1;  // lanes adding a column's row groups
  while (Sp < cs.S) Sp *= 2;
  const int lgp = __ffs(Sp) - 1, gp = tid & (Sp - 1), wc = cs.CT * 32;
  int Lx = 1;  // lanes adding a slot's C partials
  while (2 * Lx <= C && 2 * Lx * k <= kClusterThreads) Lx *= 2;
  const int lgx = __ffs(Lx) - 1, hx = tid & (Lx - 1);
  const int c0 = rank * lay.W;
  const int w = max(0, min(lay.W, m - c0));
  // the rank-1 update: thread (ur, l) takes rows t + 1 + ur, + rs, ... of
  // columns l, l + cw, ...
  const int cw = min(w, kClusterThreads);
  const int rs = cw > 0 ? kClusterThreads / cw : 0;
  const int ur = cw > 0 ? tid / cw : 0, ul0 = tid - ur * cw;
  const long long mm = m;
  const long long off = blockIdx.y * k * mm + c0;
  const float* p0b = p0 + off;
  for (int e = tid; e < k * w; e += kClusterThreads) {
    const int j = e / w, l = e - j * w;
    Us[j * ld + l] = p0b[j * mm + l];
  }
  ogp::exchange_init(x);  // synchronises the cluster, so the block too

  for (int t = 0; t < k; ++t) {
    OGP_STAMP(k, t, 0);
    float* pt = Us + t * ld;
    // 1. U_j . p (j < t), |p|^2 (j = t), r_j . p (j > t): exchange use t
    ogp::exchange_expect(x, t, k);
    row_partials(Us, ld, pt, k, k, w, lay.Sr, x, t);
    OGP_STAMP(k, t, 1);
    ogp::exchange_wait(x, t);
    OGP_STAMP(k, t, 2);
    const float* rb = x.recv + (t & 1) * C * x.stride;
    for (int j0 = 0; j0 < k; j0 += kClusterThreads >> lgx) {
      const int j = j0 + (tid >> lgx);
      float sum = 0.f;
      if (j < k)
        for (int r = hx; r < C; r += Lx) sum += rb[r * x.stride + j];
      for (int o = Lx >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (j < k && hx == 0) v[j] = sum;
    }
    __syncthreads();
    OGP_STAMP(k, t, 3);
    // 2. P^T v, R^T v partials; the scalars; rows past t
    col_partials<2, false>(Ps, Rs, ld, v, 1.f, t, w, cs, task, red);
    OGP_STAMP(k, t, 4);
    const float s2 = v[t];
    const float s = sqrtf(s2);
    const float inv_s = s > 1e-20f ? 1.f / s : 0.f;
    const float r1 = sqrtf(s2 + 1.f);
    const float c = r1 - 1.f;
    const float d = 1.f / r1 - 1.f;
    const float di = d * inv_s;
    if (ur < rs) {
      for (int l = ul0; l < w; l += cw) {
        const float u = pt[l] * inv_s;
        int tr = t + 1 + ur;
        for (; tr + 3 * rs < k; tr += 4 * rs) {  // four rows' loads in flight
          float o[4], f[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i] = Us[(tr + i * rs) * ld + l];
            f[i] = v[tr + i * rs];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) Us[(tr + i * rs) * ld + l] = fmaf(di * f[i], u, o[i]);
        }
        for (; tr < k; tr += rs) Us[tr * ld + l] = fmaf(di * v[tr], u, Us[tr * ld + l]);
      }
    }
    OGP_STAMP(k, t, 5);
    __syncthreads();  // red is complete; p is read no more
    OGP_STAMP(k, t, 6);
    // 3. row t of U, P, R
    for (int l0 = 0; l0 < w; l0 += kClusterThreads >> lgp) {
      const int l = l0 + (tid >> lgp);
      float a0 = 0.f, a1 = 0.f;
      if (l < w && gp < cs.S) {
        a0 = red[gp * wc + l];
        a1 = red[(cs.S + gp) * wc + l];
      }
      for (int o = Sp >> 1; o > 0; o >>= 1) {
        a0 += __shfl_xor_sync(0xffffffffu, a0, o);
        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      }
      if (l < w && gp == 0) {
        const float ul = pt[l] * inv_s;
        pt[l] = ul;
        Ps[t * ld + l] = d * (ul + inv_s * a0);
        Rs[t * ld + l] = c * (ul + inv_s * a1);
      }
    }
    OGP_STAMP(k, t, 7);
    __syncthreads();  // rows t of U, P, R and row t + 1 (p) are read at step t + 1
    OGP_STAMP(k, t, 8);
  }
  for (int e = tid; e < k * w; e += kClusterThreads) {
    const int j = e / w, l = e - j * w;
    U[off + j * mm + l] = Us[j * ld + l];
    Pm[off + j * mm + l] = Ps[j * ld + l];
    R[off + j * mm + l] = Rs[j * ld + l];
  }
  cluster.sync();  // no block leaves while a push to another may be in flight
}

// (b) on G clusters of lay.C blocks per output, grid (C G, Bd); slots:
// (Bd, 2, G, k + 1) zeroed words, output b's at slots[b].
__global__ void __launch_bounds__(kClusterThreads)
chunk_recursion_grid_kernel(const float* __restrict__ p0, float* __restrict__ U, float* __restrict__ Pm,
                            float* __restrict__ R, int k, int m, ChunkClusterLayout lay, int G,
                            unsigned long long* __restrict__ slots) {
  const int C = lay.C;
  const ogp::GridExchange gx{slots + blockIdx.y * (2LL * G * (k + 1)), G, k + 1,
                             static_cast<int>(blockIdx.x) / C, cg::this_cluster().block_rank() == 0};
  chunk_recursion_cluster_body<3, ogp::kMaxGridClusters>(p0, U, Pm, R, k, m, lay, gx);
}

// (b) spread over the card: the recursion past what G <= 8 clusters hold
// with every slice in shared memory (m > 8,960 at k = 128), or where the
// card cannot hold those G clusters at once. G <= 16 clusters of lay.C
// blocks per output, as many as the card holds at once
// (chunk_spread_plan in ops/cuda_root_update.py), grid (C G, Bd), the
// sums in the grid kernel's two levels and order; kSlices of U, P, R in
// shared memory (3, else U alone, else none) and the rest read and written
// in the outputs in device memory, where the step's row and column passes
// stream them (P and R, 2 k m floats, 33.6 MB at m = 32,400, k = 128: the
// L2 holds them). Slots as the grid kernel's.
template <int kSlices>
__global__ void __launch_bounds__(kClusterThreads)
chunk_recursion_spread_kernel(const float* __restrict__ p0, float* __restrict__ U, float* __restrict__ Pm,
                              float* __restrict__ R, int k, int m, ChunkClusterLayout lay, int G,
                              unsigned long long* __restrict__ slots) {
  const int C = lay.C;
  const ogp::GridExchange gx{slots + blockIdx.y * (2LL * G * (k + 1)), G, k + 1,
                             static_cast<int>(blockIdx.x) / C, cg::this_cluster().block_rank() == 0};
  chunk_recursion_cluster_body<kSlices, ogp::kMaxSpreadClusters>(p0, U, Pm, R, k, m, lay, gx);
}

// ---- K5 sub on a cluster ----

// out[r ni + i] = sum over the block's w columns of X_r . Y_i (row stride
// ld), r < nr, i < ni.
struct Dots {
  const float* X;
  const float* Y;
  int nr, ni;
  float* out;
};

// Up to two Dots in one pass over the block's warps. A warp takes 8 rows
// of X by 32 of Y: lane (tile, slice) holds a 4 x 8 tile of sums, rows
// r0 + 2 c (c < 4) and i0 + 4 c (c < 8), over the columns l = slice (mod 4);
// the four slices are then added by a fixed butterfly. Twelve loads feed 32
// FMAs. Ends with __syncthreads().
__device__ __forceinline__ void cross_dots(const Dots* ds, int n, int ld, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane & 3, tt = lane >> 2;  // column slice; tile of the warp's 2 x 4
  int first[3];  // the warp tiles of ds[0..n) are [first[x], first[x + 1])
  first[0] = 0;
  for (int x = 0; x < n; ++x) first[x + 1] = first[x] + cdiv(ds[x].nr, 8) * cdiv(ds[x].ni, 32);
  for (int wt = warp; wt < first[n]; wt += kClusterWarps) {
    int x = 0;
    while (wt >= first[x + 1]) ++x;
    const Dots d = ds[x];
    const int WI = cdiv(d.ni, 32), v = wt - first[x];
    const int r0 = (v / WI) * 8 + (tt >> 2), i0 = (v % WI) * 32 + (tt & 3);
    const float* xr[4];
    const float* yi[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) xr[c] = d.X + min(r0 + 2 * c, d.nr - 1) * ld;
#pragma unroll
    for (int c = 0; c < 8; ++c) yi[c] = d.Y + min(i0 + 4 * c, d.ni - 1) * ld;
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
#pragma unroll 2
    for (int l = sl; l < w; l += 4) {
      float xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = xr[a][l];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float y = yi[c][l];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(xv[a], y, acc[a][c]);
      }
    }
    // slices (0 + 1) + (2 + 3); slice sl stores columns c = 2 sl, 2 sl + 1
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float t = acc[a][c] + __shfl_xor_sync(0xffffffffu, acc[a][c], 1);
        acc[a][c] = t + __shfl_xor_sync(0xffffffffu, t, 2);
      }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int r = r0 + 2 * a, i = i0 + 4 * c;
        if (c >> 1 == sl && r < d.nr && i < d.ni) d.out[r * d.ni + i] = acc[a][c];
      }
  }
  __syncthreads();
}

// X_r += sum_{i < n} A[r n + i] Y_i on the block's columns, r < nr (X's
// rows must not be among the Y's).
struct Combine {
  float* X;
  const float* A;
  const float* Y;
  int n;
};

constexpr int kCombineRows = 4;
constexpr int kCombineCols = 4;  // a lane's columns, 32 apart

// acc[r][c] += sum_{i < ni} A[(r0 + r) ni + i] Y_i[l + 32 c] for a lane's
// kCombineRows rows and kCombineCols columns: A's entries read four at a
// time (float4, when ni is a multiple of 4 and A 16-byte aligned), the
// same for every lane of the warp.
__device__ __forceinline__ void combine_segment(float (*acc)[kCombineCols], const float* A, const float* Y,
                                                int ni, int r0, int nr, int l, int w, int ld) {
  const float* ar[kCombineRows];
#pragma unroll
  for (int r = 0; r < kCombineRows; ++r) ar[r] = A + min(r0 + r, nr - 1) * ni;
  int col[kCombineCols];
#pragma unroll
  for (int c = 0; c < kCombineCols; ++c) col[c] = min(l + 32 * c, w - 1);
  const bool vec = (ni & 3) == 0 && (reinterpret_cast<unsigned long long>(A) & 15) == 0;
  int i = 0;
  if (vec) {
    for (; i < ni; i += 4) {
      float y[4][kCombineCols];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kCombineCols; ++c) y[e][c] = Y[(i + e) * ld + col[c]];
#pragma unroll
      for (int r = 0; r < kCombineRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(ar[r] + i);
#pragma unroll
        for (int c = 0; c < kCombineCols; ++c) {
          acc[r][c] = fmaf(a.x, y[0][c], acc[r][c]);
          acc[r][c] = fmaf(a.y, y[1][c], acc[r][c]);
          acc[r][c] = fmaf(a.z, y[2][c], acc[r][c]);
          acc[r][c] = fmaf(a.w, y[3][c], acc[r][c]);
        }
      }
    }
  }
  for (; i < ni; ++i) {
    float y[kCombineCols];
#pragma unroll
    for (int c = 0; c < kCombineCols; ++c) y[c] = Y[i * ld + col[c]];
#pragma unroll
    for (int r = 0; r < kCombineRows; ++r)
#pragma unroll
      for (int c = 0; c < kCombineCols; ++c) acc[r][c] = fmaf(ar[r][i], y[c], acc[r][c]);
  }
}

// Up to two Combines in one pass: a warp takes kCombineRows rows and
// 32 kCombineCols columns, lanes over columns. Ends with __syncthreads().
__device__ __forceinline__ void row_combine(const Combine* cms, int n, int ld, int nr, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int RB = cdiv(nr, kCombineRows), CB = cdiv(w, 32 * kCombineCols);
  for (int wt = warp; wt < n * RB * CB; wt += kClusterWarps) {
    const int which = wt / (RB * CB), rest = wt - which * RB * CB;
    const int rb = rest / CB, l = (rest - rb * CB) * 32 * kCombineCols + lane, r0 = rb * kCombineRows;
    const Combine cm = cms[which];
    float acc[kCombineRows][kCombineCols];
#pragma unroll
    for (int r = 0; r < kCombineRows; ++r)
#pragma unroll
      for (int c = 0; c < kCombineCols; ++c) acc[r][c] = 0.f;
    combine_segment(acc, cm.A, cm.Y, cm.n, r0, nr, l, w, ld);
#pragma unroll
    for (int r = 0; r < kCombineRows; ++r)
#pragma unroll
      for (int c = 0; c < kCombineCols; ++c)
        if (r0 + r < nr && l + 32 * c < w) cm.X[(r0 + r) * ld + l + 32 * c] += acc[r][c];
  }
  __syncthreads();
}

constexpr int kMaxCluster = 8;

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// coef[0, n) of every block of the cluster summed in rank order; every block
// ends with the sums in its coef. Block r sums entries [r S, r S + S),
// S = cdiv(n, C), over DSMEM into its csum, and every block then gathers
// the C csums. Between the two cluster barriers the blocks read only each
// other's coef, after them only each other's csum, so one buffer of each
// serves every call: a block's coef is read by others only before the
// call's second barrier, and its csum is rewritten only after the next
// call's first barrier, which no block passes before all have gathered.
// The block has kThreads threads; each keeps kBatch loads of the gather in
// flight. V = float4 moves four entries a load (n a multiple of 4 C, coef
// and csum 16-byte aligned); each entry's sum is the same as with
// V = float. A block that reads no DSMEM after its last
// call must still not exit before the others have gathered from its csum.
template <int kThreads = kClusterThreads, typename V = float, int kBatch = 4>
__device__ __forceinline__ void cluster_reduce(cg::cluster_group& cluster, float* coef, float* csum,
                                               int n, int C, int rank) {
  constexpr int kW = sizeof(V) / sizeof(float);
  V* cv = reinterpret_cast<V*>(coef);
  V* sv = reinterpret_cast<V*>(csum);
  n /= kW;
  cluster.sync();  // every block's partials are written
  const int S = cdiv(n, C);
  for (int i = threadIdx.x; i < S && rank * S + i < n; i += kThreads) {
    V v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) v[r] = *cluster.map_shared_rank(cv + rank * S + i, r);
    V s = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < C) s = vadd(s, v[r]);
    sv[i] = s;
  }
  cluster.sync();  // every block's sums are written
  // kBatch loads in flight a thread before its stores
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    V v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kThreads, r = e / S;
      if (e < n) v[b] = *cluster.map_shared_rank(sv + (e - r * S), r);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (e0 + b * kThreads < n) cv[e0 + b * kThreads] = v[b];
  }
  __syncthreads();
}

// X_r += sum_{i < n} (X_r . Y_i) Z_i for the rows r < sub of the nc
// (X, Y, Z) of one sub-block boundary, the dots summed across the cluster.
// The boundary's coefficients go through the block's step buffers (cb.bnd:
// cap coefficients, then a block's share of their sums), in as few rounds
// of rows as fit, the rows spread evenly over the rounds. One row always
// fits: n nc <= 2 (k - sub), and the receive buffers alone are 2 C (k + 1)
// floats. Each round: register-tiled dots over the block's columns,
// cluster_reduce, and the update of its rows.
struct Collapse {
  float* X;
  const float* Y;
  const float* Z;
};

__device__ __forceinline__ void boundary_update(cg::cluster_group& cluster, const ClusterBlock& cb,
                                                const Collapse* cl, int nc, int n, int sub, int C,
                                                int rank) {
  const int cap = static_cast<int>((cb.nbnd - 1LL) * C / (C + 1));
  const int rounds = cdiv(sub, min(sub, cap / (nc * n)));
  const int R = cdiv(sub, rounds);
  float* coef = cb.bnd;
  for (int r0 = 0; r0 < sub; r0 += R) {
    const int nr = min(R, sub - r0);
    Dots ds[2];
    Combine cms[2];
    for (int x = 0; x < nc; ++x) {
      float* X = cl[x].X + r0 * cb.ld;
      ds[x] = Dots{X, cl[x].Y, nr, n, coef + x * nr * n};
      cms[x] = Combine{X, coef + x * nr * n, cl[x].Z, n};
    }
    cross_dots(ds, nc, cb.ld, cb.w);
    cluster_reduce(cluster, coef, coef + cap, nc * nr * n, C, rank);
    row_combine(cms, nc, cb.ld, nr, cb.w);
  }
}

// (b) K5 sub: the two-level recursion on a cluster of lay.C blocks per
// output, grid (C, Bd), on K1's layout, with the sub-blocks' products
// collapsed into one rank-k operator (collapse_sub_factors in
// ops/root_update.py): writes rows 0..k-1 of U, Pc, Rc, so that the chunk
// is L (I + Rc^T U), B (I + Pc^T U). Sub-block j (rows [J, J + sub)) runs
// K1's cluster step on its own rows, its raw rows (p0, held in the rows of
// U not yet written) having been corrected in one step at the boundary
// before it. The boundary after it first collapses its rows,
//     Rc_j = R_j + (R_j U_{<J}^T) Rc_{<J},  Pc_j = P_j + (P_j U_{<J}^T) Pc_{<J},
// then corrects the next sub-block's raw rows q, q += (q Pc_{<J+sub}^T) U_{<J+sub}.
// Stamps 10 and 11 of step J + sub - 1 bracket a boundary.
__global__ void __launch_bounds__(kClusterThreads)
chunk_sub_cluster_kernel(const float* __restrict__ p0, float* __restrict__ U, float* __restrict__ Pm,
                         float* __restrict__ R, int k, int sub, int m, ChunkClusterLayout lay) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const ClusterBlock cb = cluster_block(sh, k, m, rank, lay);
  const int tid = threadIdx.x, ld = cb.ld, w = cb.w;
  const long long mm = m;
  const float* p0b = p0 + cb.off;
  // every raw row into its row of U: rows >= t are read only as input rows
  for (int e = tid; e < k * w; e += kClusterThreads) {
    const int j = e / w, l = e - j * w;
    cb.Us[j * ld + l] = p0b[j * mm + l];
  }
  ogp::exchange_init(cb.x);  // synchronises the cluster, so the block too

  for (int J = 0; J < k; J += sub) {
    for (int t = 0; t < sub; ++t) {
      const int tg = J + t;
      OGP_STAMP(k, tg, 0);
      for (int l = tid; l < w; l += kClusterThreads) cb.q[l] = cb.Us[tg * ld + l];
      __syncthreads();
      OGP_STAMP(k, tg, 1);
      cluster_step(cb, cb.Us + J * ld, cb.Ps + J * ld, cb.Rs + J * ld, t, tg, k, tg);
    }
    const int nx = J + sub;  // the next sub-block's first row
    OGP_STAMP(k, nx - 1, 10);
    if (J > 0) {
      const Collapse cl[2] = {{cb.Rs + J * ld, cb.Us, cb.Rs}, {cb.Ps + J * ld, cb.Us, cb.Ps}};
      boundary_update(cluster, cb, cl, 2, J, sub, lay.C, rank);
    }
    if (nx < k) {
      const Collapse cl[1] = {{cb.Us + nx * ld, cb.Ps, cb.Us}};
      boundary_update(cluster, cb, cl, 1, nx, sub, lay.C, rank);
      // the sums sat in the receive buffers: no block pushes the next step
      // into them before every block has gathered them
      cluster.sync();
    }
    OGP_STAMP(k, nx - 1, 11);
  }
  cluster_store(cb, U, Pm, R, k, m);
  cluster.sync();  // no block leaves while a push to another may be in flight
}

// The spread kernel with `slices` factor slices in shared memory (3, 1
// or 0), or null for any other count.
using SpreadKernel = void (*)(const float*, float*, float*, float*, int, int, ChunkClusterLayout, int,
                              unsigned long long*);
SpreadKernel spread_kernel(int slices) {
  switch (slices) {
    case 3: return chunk_recursion_spread_kernel<3>;
    case 1: return chunk_recursion_spread_kernel<1>;
    case 0: return chunk_recursion_spread_kernel<0>;
    default: return nullptr;
  }
}

// (b) for Bd outputs: with spread >= 0, spread over G clusters of C blocks
// per output with `spread` slices in shared memory; else on G clusters of C
// blocks per output, by the carried kernel where G = 1. With G > 1 or
// spread (slots: (Bd, 2, G, k + 1) zeroed words) the launches run in waves
// of `wave` outputs, in order on the stream, each checked to fit the card
// at once (G clusters per output wait on each other). Returns a
// cudaError_t, or ogp::kNoCluster.
int chunk_recursion(const float* p0, float* U, float* Pm, float* R, int Bd, int k, int m, int C, int G,
                    int wave, int spread, unsigned long long* slots, cudaStream_t s) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (spread >= 0 || G > 1) {
    const int max_g = spread >= 0 ? ogp::kMaxSpreadClusters : ogp::kMaxGridClusters;
    const SpreadKernel spread_k = spread >= 0 ? spread_kernel(spread) : nullptr;
    if (G < 1 || G > max_g || wave < 1 || slots == nullptr || (spread >= 0 && spread_k == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const ChunkClusterLayout lay = chunk_cluster_layout(k, m, C, G, spread >= 0 ? spread : 3);
    const long long smem = lay.floats * static_cast<long long>(sizeof(float));
    const long long km = static_cast<long long>(k) * m, words = 2LL * G * (k + 1);
    for (int b0 = 0; b0 < Bd; b0 += wave) {
      const int nb = Bd - b0 < wave ? Bd - b0 : wave;
      const int rc = spread_k != nullptr
          ? ogp::launch_cluster_grid(spread_k, C, dim3(C * G, nb, 1), kClusterThreads, smem, s, nb * G,
                                     p0 + b0 * km, U + b0 * km, Pm + b0 * km, R + b0 * km, k, m, lay, G,
                                     slots + b0 * words)
          : ogp::launch_cluster_grid(chunk_recursion_grid_kernel, C, dim3(C * G, nb, 1), kClusterThreads, smem,
                                     s, nb * G, p0 + b0 * km, U + b0 * km, Pm + b0 * km, R + b0 * km, k, m,
                                     lay, G, slots + b0 * words);
      if (rc != 0) return rc;
    }
    return 0;
  }
  if (G != 1) return static_cast<int>(cudaErrorInvalidValue);
  const ChunkClusterLayout lay = chunk_cluster_layout(k, m, C);
  return ogp::launch_cluster(chunk_recursion_carried_kernel, C, Bd,
                             lay.floats * static_cast<long long>(sizeof(float)), s, p0, U, Pm, R, k, m, lay);
}

// ---- (c) K1's apply ----
//
// On thread-block clusters (chunk_apply_cluster_kernel), as the file's
// header describes: a cluster of C blocks owns one tile of kApplyBM rows of
// one X of (L, B), block r its columns [r W, r W + W).
constexpr int kApplyBM = 64;       // rows of X a cluster owns
constexpr int kApplyThreads = 256;
constexpr int kApplyStages = 3;    // ring slots
constexpr int kApplyL = 32;        // columns of X and A a T-stage slot holds
constexpr int kApplyTJ = 128;      // columns of T a pass of the T stage forms
constexpr int kApplyUJ = 32;       // rows of U an update slot holds
constexpr int kApplyUC = 128;      // columns of the slice an update chunk covers
constexpr int kApplyLDA = kApplyTJ + 4;  // row length of a slot's A^T: 16-byte rows, 4 banks apart
constexpr int kApplySlot = kApplyBM * kApplyL + kApplyL * kApplyLDA;  // floats a ring slot holds
static_assert(kApplyUJ * kApplyUC <= kApplySlot, "an update slot fits a ring slot");
constexpr int kApplyRT = kApplyBM / 16;  // rows of the tile a thread owns
static_assert(kApplyThreads == 256 && kApplyBM % 16 == 0 && kApplyTJ == 128 && kApplyUC == 128,
              "16 x 16 threads, each kApplyRT rows and 8 columns, cover kApplyBM x 128");

// One block's shared memory: T (kApplyBM x ldt, ldt = k rounded up to
// kApplyUJ), the block's share of T's cluster sums (kApplyBM ldt / C) and
// the ring, each T-stage slot a kApplyBM x 32 block of X (row-major, rows
// swizzled) and the matching 32 x 128 block of A^T, each update slot 32
// rows of U's 128-column chunk. W is cdiv(m, C) rounded up to 4, so
// 16-byte copies of a slice start aligned.
struct ApplyLayout {
  int W, ldt;
  long long floats;
};

__host__ __device__ inline ApplyLayout chunk_apply_layout(int k, int m, int C) {
  const int W = 4 * cdiv(cdiv(m, C), 4);
  const int ldt = kApplyUJ * cdiv(k, kApplyUJ);
  const long long t = static_cast<long long>(kApplyBM) * ldt;
  return ApplyLayout{W, ldt, t + t / C + static_cast<long long>(kApplyStages) * kApplySlot};
}

// The float4 at (i, 4 g) of a buffer of row length ld whose rows keep their
// 16-byte groups swizzled (tile_async's swz).
__device__ __forceinline__ const float4* swz4(const float* p, int i, int g, int ld) {
  return reinterpret_cast<const float4*>(p + i * ld + ((g ^ (i & 7)) << 2));
}

// A's kApplyTJ x kApplyL block at src (row stride ld) into the slot as A^T,
// element (j, l) at l kApplyLDA + j, by 4-byte copies (zero where j >= nj
// or l >= nl), by all kApplyThreads threads. Thread t copies column
// l = (t & 7) + 8 ((t >> 5) & 3) of rows j = ((t >> 3) & 3) + 4 (t >> 7) +
// 8 it: a warp copies eight columns of four rows, 32-byte pieces of global
// memory into 32 distinct banks of shared memory.
__device__ __forceinline__ void transpose_async(float* dst, const float* src, long long ld, int nj, int nl,
                                                const float* any) {
  static_assert(kApplyThreads == 256 && kApplyTJ * kApplyL == 16 * kApplyThreads, "16 copies a thread");
  const int t = threadIdx.x;
  const int l = (t & 7) + 8 * ((t >> 5) & 3), j0 = ((t >> 3) & 3) + 4 * (t >> 7);
  const float* s = src + j0 * ld + l;
  float* d = dst + l * kApplyLDA + j0;
  const bool lok = l < nl;
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const bool ok = lok && j0 + 8 * it < nj;
    ogp::cp_async4(d + 8 * it, ok ? s + 8 * it * ld : any, ok);
  }
}

// grid (C, row tiles, 2 Bd) in clusters of C along x; X is (Bd, rows, m).
// Thread (ti, tj) owns rows ti + 16 a (a < kApplyRT) of the tile and
// columns 4 tj + [0, 4) and 64 + 4 tj + [0, 4) of a 128-column pass of T
// (or chunk of the slice). In both stages one factor is a value the thread
// broadcasts over its 8 columns (X's, or T's, four a 16-byte load along the
// sum's index) and the other a pair of 16-byte loads across those columns
// (A^T's, or U's). A quarter-warp shares ti, so its loads of X and T are
// broadcasts; its eight tj read 128 contiguous bytes. Sums: T_r(i, j) an
// fmaf chain over the block's columns in order, T = the C partials in rank
// order, X + (an fmaf chain over j < k).
__global__ void __launch_bounds__(kApplyThreads, 2)
chunk_apply_cluster_kernel(float* L, float* B, const float* R, const float* Pm, const float* U, int k,
                           int rows, int m, ApplyLayout lay) {
  extern __shared__ __align__(16) float apply_sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.z >> 1, mm = m;
  const int w = blockIdx.z & 1;
  const int row0 = blockIdx.y * kApplyBM, c0 = rank * lay.W;
  const int wr = max(0, min(lay.W, m - c0));  // this block's columns
  const int nr = min(kApplyBM, rows - row0);  // the tile's rows
  const bool vec = (m & 3) == 0;              // then every row and slice starts 16-byte aligned
  const int ldt = lay.ldt;
  float* X0 = w ? B : L;
  const float* A0 = w ? Pm : R;
  float* X = X0 + (b * rows + row0) * mm + c0;
  const float* A = A0 + b * k * mm + c0;
  const float* Ub = U + b * k * mm + c0;
  float* Ts = apply_sh;
  float* csum = Ts + kApplyBM * ldt;
  float* ring = csum + kApplyBM * ldt / C;

  // the ring's slots in order: the T stage's (pass jb, column chunk lc) of
  // X and A, then the update's (column chunk cc, row chunk ju) of U
  const int nJB = cdiv(k, kApplyTJ), nL = cdiv(wr, kApplyL), nT = nJB * nL;
  const int nU = cdiv(wr, kApplyUC), nJU = cdiv(k, kApplyUJ), nS = nT + nU * nJU;
  auto issue = [&](int s) {
    float* slot = ring + (s % kApplyStages) * kApplySlot;
    if (s < nT) {
      const int jb = s / nL, l0 = (s - jb * nL) * kApplyL;
      ogp::tile_async(slot, kApplyL, true, X + l0, mm, kApplyBM, kApplyL / 4, nr, wr - l0, vec, X0);
      transpose_async(slot + kApplyBM * kApplyL, A + jb * kApplyTJ * mm + l0, mm, k - jb * kApplyTJ, wr - l0,
                      A0);
    } else {
      const int u = s - nT, cc = u / nJU, j0 = (u - cc * nJU) * kApplyUJ;
      ogp::tile_async(slot, kApplyUC, false, Ub + j0 * mm + cc * kApplyUC, mm, kApplyUJ, kApplyUC / 4,
                      k - j0, wr - cc * kApplyUC, vec, U);
    }
  };
#pragma unroll
  for (int s = 0; s < kApplyStages - 1; ++s) {
    if (s < nS) issue(s);
    ogp::cp_async_commit();
  }
  int s = 0;
  // waits for slot s, then queues slot s + kApplyStages - 1 into the slot
  // every thread finished with at the last iteration
  auto next = [&]() -> const float* {
    ogp::cp_async_wait<kApplyStages - 2>();
    __syncthreads();
    if (s + kApplyStages - 1 < nS) issue(s + kApplyStages - 1);
    ogp::cp_async_commit();
    return ring + (s % kApplyStages) * kApplySlot;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ti = (lane >> 3) + 4 * (warp >> 1);
  const int tj = (lane & 7) + 8 * (warp & 1);

  // T_r = X_slice A_slice^T, 128 columns of T a pass
  for (int jb = 0; jb < nJB; ++jb) {
    float acc[kApplyRT][8];
#pragma unroll
    for (int a = 0; a < kApplyRT; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
    for (int lc = 0; lc < nL; ++lc, ++s) {
      const float* Xs = next();
      const float* At = Xs + kApplyBM * kApplyL;
#pragma unroll 2
      for (int g = 0; g < kApplyL / 4; ++g) {
        float4 xv[kApplyRT];
#pragma unroll
        for (int a = 0; a < kApplyRT; ++a) xv[a] = *swz4(Xs, ti + 16 * a, g, kApplyL);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 av[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[h] = *reinterpret_cast<const float4*>(At + (4 * g + q) * kApplyLDA + 64 * h + 4 * tj);
#pragma unroll
          for (int a = 0; a < kApplyRT; ++a) {
            const float x = q == 0 ? xv[a].x : q == 1 ? xv[a].y : q == 2 ? xv[a].z : xv[a].w;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              acc[a][4 * h] = fmaf(x, av[h].x, acc[a][4 * h]);
              acc[a][4 * h + 1] = fmaf(x, av[h].y, acc[a][4 * h + 1]);
              acc[a][4 * h + 2] = fmaf(x, av[h].z, acc[a][4 * h + 2]);
              acc[a][4 * h + 3] = fmaf(x, av[h].w, acc[a][4 * h + 3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kApplyRT; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = ti + 16 * a, j = jb * kApplyTJ + 64 * (c >> 2) + 4 * tj + (c & 3);
        if (j < ldt) Ts[i * ldt + (((j >> 2) ^ (i & 7)) << 2) + (j & 3)] = acc[a][c];
      }
  }
  cluster_reduce<kApplyThreads, float4, 16>(cluster, Ts, csum, kApplyBM * ldt, C, rank);
  // this block reads no other block's shared memory from here on; none may
  // exit before every block has gathered from its csum
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  // X_slice += T U_slice, 128 columns at a time
  for (int cc = 0; cc < nU; ++cc) {
    // the chunk of X the epilogue reads: on its way to L2 while the chunk
    // computes (four 128-byte lines a row)
    for (int e = threadIdx.x; e < kApplyBM * 4; e += kApplyThreads) {
      const int i = e >> 2, c = cc * kApplyUC + 32 * (e & 3);
      if (i < nr && c < wr) asm volatile("prefetch.global.L2 [%0];" ::"l"(X + i * mm + c));
    }
    float acc[kApplyRT][8];
#pragma unroll
    for (int a = 0; a < kApplyRT; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
    for (int ju = 0; ju < nJU; ++ju, ++s) {
      const float* Us = next();
      const int g0 = ju * (kApplyUJ / 4);
#pragma unroll 2
      for (int g = 0; g < kApplyUJ / 4; ++g) {
        float4 tv[kApplyRT], uv[4][2];
#pragma unroll
        for (int a = 0; a < kApplyRT; ++a) tv[a] = *swz4(Ts, ti + 16 * a, g0 + g, ldt);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            uv[q][h] = *reinterpret_cast<const float4*>(Us + (4 * g + q) * kApplyUC + 64 * h + 4 * tj);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int a = 0; a < kApplyRT; ++a) {
            const float t = q == 0 ? tv[a].x : q == 1 ? tv[a].y : q == 2 ? tv[a].z : tv[a].w;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              acc[a][4 * h] = fmaf(t, uv[q][h].x, acc[a][4 * h]);
              acc[a][4 * h + 1] = fmaf(t, uv[q][h].y, acc[a][4 * h + 1]);
              acc[a][4 * h + 2] = fmaf(t, uv[q][h].z, acc[a][4 * h + 2]);
              acc[a][4 * h + 3] = fmaf(t, uv[q][h].w, acc[a][4 * h + 3]);
            }
          }
      }
    }
#pragma unroll
    for (int a = 0; a < kApplyRT; ++a) {
      const int i = ti + 16 * a;
      if (i >= nr) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = cc * kApplyUC + 64 * h + 4 * tj;  // the thread's first column in the slice
        if (c >= wr) continue;
        float* out = X + i * mm + c;
        if (vec) {
          float4 x = *reinterpret_cast<const float4*>(out);
          x.x += acc[a][4 * h];
          x.y += acc[a][4 * h + 1];
          x.z += acc[a][4 * h + 2];
          x.w += acc[a][4 * h + 3];
          *reinterpret_cast<float4*>(out) = x;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < wr) out[q] += acc[a][4 * h + q];
        }
      }
    }
  }
  ogp::cp_async_wait<0>();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// (c1) T[b, w] = X_w[b] A_w[b]^T, (X_0, A_0) = (L, R), (X_1, A_1) = (B, P),
// over the rows L and B hold, (Bd, rows, m) (rows = m for the whole
// chunk); T is (Bd, 2, rows, k). grid (k tiles, row tiles, 2 Bd). The
// tiled kernels run the apply where chunk_apply_plan holds no cluster
// (k too large for T in one block's shared memory).
__global__ void __launch_bounds__(kGemmThreads)
chunk_apply_t_kernel(const float* L, const float* B, const float* R, const float* Pm, float* T,
                     int k, int rows, int m) {
  const long long b = blockIdx.z >> 1, mm = m, rr = rows;
  const int w = blockIdx.z & 1;
  const float* X = (w ? B : L) + b * rr * mm;
  const float* A = (w ? Pm : R) + b * k * mm;
  float* Tb = T + (b * 2 + w) * rr * k;
  // T(i, j) = sum_l X(i, l) A(j, l)
  gemm_tile(rows, k, m, X, mm, 1, A, 1, mm, Tb, k, 1.f, false, blockIdx.y * kTileM,
            blockIdx.x * kTileN);
}

// (c2) X_w[b] += T[b, w] U[b], in place. grid (m tiles, row tiles, 2 Bd)
__global__ void __launch_bounds__(kGemmThreads)
chunk_apply_x_kernel(float* L, float* B, const float* T, const float* U, int k, int rows, int m) {
  const long long b = blockIdx.z >> 1, mm = m, rr = rows;
  const int w = blockIdx.z & 1;
  float* X = (w ? B : L) + b * rr * mm;
  const float* Tb = T + (b * 2 + w) * rr * k;
  const float* Ub = U + b * k * mm;
  gemm_tile(rows, m, k, Tb, k, 1, Ub, mm, 1, X, mm, 1.f, true, blockIdx.y * kTileM,
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
// p[((z / div) % mod) * bs + r * rs + c * cs] (e.g. div 2: one matrix per
// pair of batches; mod Bd: batch z = w Bd + b takes output b's matrix).
struct MatArg {
  const float* p;
  long long rs, cs, bs;
  int div, mod;
};
constexpr int kEveryBatch = 1 << 30;  // a MatArg mod that changes nothing

// C[z] = [C[z] +] alpha A[z] B[z] for z = blockIdx.z, C[z] at C + z * c_bs
// with row stride c_rs. grid (N tiles, M tiles, batches)
__global__ void __launch_bounds__(kGemmThreads)
batched_gemm_kernel(int M, int N, int K, MatArg a, MatArg b, float* C, long long c_rs,
                    long long c_bs, float alpha, bool accumulate) {
  const int z = blockIdx.z;
  gemm_tile(M, N, K, a.p + ((z / a.div) % a.mod) * a.bs, a.rs, a.cs,
            b.p + ((z / b.div) % b.mod) * b.bs, b.rs, b.cs, C + z * c_bs, c_rs, alpha, accumulate,
            blockIdx.y * kTileM, blockIdx.x * kTileN);
}

cudaError_t gemm(int M, int N, int K, MatArg a, MatArg b, float* C, long long c_rs,
                 long long c_bs, int batches, float alpha, bool accumulate, cudaStream_t s) {
  dim3 grid(cdiv(N, kTileN), cdiv(M, kTileM), batches);
  batched_gemm_kernel<<<grid, kGemmThreads, 0, s>>>(M, N, K, a, b, C, c_rs, c_bs, alpha,
                                                     accumulate);
  return cudaGetLastError();
}

constexpr int kGramTile = 16;
constexpr int kGramSplit = 4;  // column ranges of M's partials

// (K5 coord) partials of M = P0 P0^T, the lower triangle only (the
// recursion reads nothing above the diagonal): block (tile, x, b) forms
// one kGramTile^2 tile of it over column range x of kGramSplit, one entry
// a thread, 32-column slabs through shared memory with the next slab's
// loads in flight, even and odd columns in two accumulators.
// Mp: (Bd, kGramSplit, k, k); the recursion adds the partials in order.
// grid (lower tiles, kGramSplit, Bd)
__global__ void __launch_bounds__(kGramTile * kGramTile)
coord_gram_kernel(const float* __restrict__ p0, float* __restrict__ Mp, int k, int m) {
  __shared__ float As[kGramTile][33], Bs[kGramTile][33];
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const long long mm = m;
  const float* P = p0 + blockIdx.z * static_cast<long long>(k) * mm;
  const int span = cdiv(cdiv(m, kGramSplit), 32) * 32;
  const int lbeg = blockIdx.y * span, lend = min(m, lbeg + span);
  const int tx = threadIdx.x % kGramTile, ty = threadIdx.x / kGramTile;
  // this thread's two slab entries of each operand: rows r, columns c
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int gi = ti * kGramTile + r, gj = tj * kGramTile + r;
  auto load = [&](int l0, float* va, float* vb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gl = l0 + c + 16 * h;
      va[h] = gi < k && gl < lend ? P[gi * mm + gl] : 0.f;
      vb[h] = gj < k && gl < lend ? P[gj * mm + gl] : 0.f;
    }
  };
  float va[2], vb[2];
  load(lbeg, va, vb);
  float acc0 = 0.f, acc1 = 0.f;
  for (int l0 = lbeg; l0 < lend; l0 += 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      As[r][c + 16 * h] = va[h];
      Bs[r][c + 16 * h] = vb[h];
    }
    __syncthreads();
    if (l0 + 32 < lend) load(l0 + 32, va, vb);
#pragma unroll
    for (int x = 0; x < 32; x += 2) {
      acc0 = fmaf(As[ty][x], Bs[tx][x], acc0);
      acc1 = fmaf(As[ty][x + 1], Bs[tx][x + 1], acc1);
    }
    __syncthreads();
  }
  const int i = ti * kGramTile + ty, j = tj * kGramTile + tx;
  if (i < k && j <= i)
    Mp[(blockIdx.z * static_cast<long long>(kGramSplit) + blockIdx.y) * k * k + i * k + j] = acc0 + acc1;
}

constexpr int kCoordThreads = 1024;

// K5 coord's shared memory: the lower triangles (diagonal included) of Ut,
// Pt, Rt and W, packed by columns (column l holds rows l..k-1 from
// lower_col(k, l)); the strict upper triangles of Y and Q, packed by
// columns (column l holds rows 0..l-1 from upper_col(l)); pi and h; 32
// warp partials. 3 k^2 + 3 k + 32 floats.
__host__ __device__ inline int lower_col(int k, int l) { return l * k - l * (l - 1) / 2; }
__host__ __device__ inline int upper_col(int l) { return l * (l - 1) / 2; }
__host__ __device__ inline long long coord_floats(int k) { return 3LL * k * k + 3LL * k + 32; }

// Threads that share a row or a column in a step's passes: a power of two
// up to 32 (lanes of one warp) that gives every one of the k its group.
__device__ __forceinline__ int coord_group(int k) {
  int G = 1;
  while (G < 32 && 2 * G * k <= kCoordThreads) G *= 2;
  return G;
}

// The sum over the G lanes of a group (a fixed butterfly: every lane of
// the group gets the same value). Called by every lane of the warp.
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (K5 coord) the k-step recursion on coordinates, one block per output.
// u_t = Ut_t P0, p_t = Pt_t P0, r_t = Rt_t P0 as in blocked_factors_coord
// (ops/root_update.py), but the inner products it takes through M there
// are carried instead, each new one a step's by-product:
//     W_ij = u_i . u_j,  Y_jl = u_j . p0_l (l > j),  Q_jl = p_j . p0_l (l > j).
// Step t with a = Q[:, t] (a_j = p_j . p0_t) and y = Y[:, t]:
//   1. h = y + W a (h_j = u_j . p for p = p0_t + sum_j a_j u_j), one
//      group of lanes a row; pi = e_t + Ut^T a, a group a column; the
//      warps' partials of s^2 = |p|^2 = M_tt + sum_j a_j (y_j + h_j);
//   2. with g = h inv_s: row t of Ut (alpha = pi inv_s), Pt, Rt and W
//      (g, and W_tt = s^2 inv_s^2), and for l > t, Y_tl =
//      (M_tl + sum_j a_j Y_jl) inv_s and Q_tl = d (Y_tl + sum_j g_j Q_jl).
// Every triangle is in shared memory and M's column t + 1 is loaded into
// registers during step t: no step waits on device memory. Two block
// barriers a step. Mg: (Bd, kGramSplit, k, k), the lower triangles of M's
// partials; writes F (3, Bd, k, k): Ut, Rt, Pt with zeros above the
// diagonal.
__global__ void __launch_bounds__(kCoordThreads)
coord_recursion_kernel(const float* __restrict__ Mg, float* __restrict__ F, int k) {
  extern __shared__ float sh[];
  const int tri = k * (k + 1) / 2, utri = k * (k - 1) / 2;
  float* Ut = sh;
  float* Pt = Ut + tri;
  float* Rt = Pt + tri;
  float* W = Rt + tri;
  float* Y = W + tri;
  float* Q = Y + utri;
  float* pi = Q + utri;  // k
  float* h = pi + k;     // k: u_j . p, unscaled
  float* red = h + k;    // 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = coord_group(k);
  const int grp = tid / G, s = tid & (G - 1);  // this thread's row or column, lane in it
  const long long kk = static_cast<long long>(k) * k;
  const float* M = Mg + blockIdx.x * kGramSplit * kk;
  const int lc = grp < k ? lower_col(k, grp) : 0;
  const int uc = grp < k ? upper_col(grp) : 0;
  // M's partials added in order: M_tt and M_l t (l = grp > t) of the
  // coming step, loaded a step ahead
  auto m_entry = [&](int i, int j) {
    float v = M[i * k + j];
#pragma unroll
    for (int x = 1; x < kGramSplit; ++x) v += M[x * kk + i * k + j];
    return v;
  };
  float mdiag = m_entry(0, 0);
  float mcol = grp > 0 && grp < k ? m_entry(grp, 0) : 0.f;
  for (int t = 0; t < k; ++t) {
    OGP_STAMP(k, t, 0);
    const float* a = Q + upper_col(t);
    const float* y = Y + upper_col(t);
    const float mtt = mdiag, mlt = mcol;
    if (t + 1 < k) {
      mdiag = m_entry(t + 1, t + 1);
      mcol = grp > t + 1 && grp < k ? m_entry(grp, t + 1) : 0.f;
    }
    // 1a. h_j for row j = grp < t: W_ji from column i for i <= j, from
    // column j for i > j
    float acc = 0.f;
    if (grp < t) {
      int i = s;
#pragma unroll 4
      for (; i <= grp; i += G) acc = fmaf(W[lower_col(k, i) + grp - i], a[i], acc);
#pragma unroll 4
      for (; i < t; i += G) acc = fmaf(W[lc + i - grp], a[i], acc);
    }
    acc = group_sum(acc, G);
    float part = 0.f;
    if (grp < t && s == 0) {
      const float hj = y[grp] + acc;
      h[grp] = hj;
      part = a[grp] * (y[grp] + hj);
    }
    // 1b. pi_l for column l = grp <= t: [l = t] + sum_{j in [l, t)} Ut_jl a_j
    acc = 0.f;
    if (grp < t) {
      for (int j = grp + s; j < t; j += G) acc = fmaf(Ut[lc + j - grp], a[j], acc);
    }
    acc = group_sum(acc, G);
    if (grp <= t && s == 0) pi[grp] = (grp == t ? 1.f : 0.f) + acc;
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    OGP_STAMP(k, t, 1);
    __syncthreads();
    OGP_STAMP(k, t, 2);
    // 2. every warp adds the 32 partials in the same fixed order
    const float s2 = fmaxf(mtt + warp_sum(lane < kCoordThreads / 32 ? red[lane] : 0.f), 0.f);
    const float sn = sqrtf(s2);
    const float inv_s = sn > 1e-20f ? 1.f / sn : 0.f;
    const float r1 = sqrtf(s2 + 1.f);
    const float c = r1 - 1.f;
    const float d = 1.f / r1 - 1.f;
    float acc0 = 0.f, acc1 = 0.f;
    if (grp <= t) {
      for (int j = grp + s; j < t; j += G) {
        acc0 = fmaf(Pt[lc + j - grp], h[j], acc0);
        acc1 = fmaf(Rt[lc + j - grp], h[j], acc1);
      }
    } else if (grp < k) {
      for (int j = s; j < t; j += G) {
        acc0 = fmaf(Y[uc + j], a[j], acc0);
        acc1 = fmaf(Q[uc + j], h[j], acc1);
      }
    }
    acc0 = group_sum(acc0, G);
    acc1 = group_sum(acc1, G);
    if (s == 0 && grp <= t) {
      const int e = lc + t - grp;  // row t of column grp
      const float al = pi[grp] * inv_s;
      Ut[e] = al;
      Pt[e] = d * (al + acc0 * inv_s);
      Rt[e] = c * (al + acc1 * inv_s);
      W[e] = grp < t ? h[grp] * inv_s : s2 * inv_s * inv_s;
    } else if (s == 0 && grp < k) {
      const float yt = (mlt + acc0) * inv_s;
      Y[uc + t] = yt;
      Q[uc + t] = d * (yt + acc1 * inv_s);
    }
    OGP_STAMP(k, t, 3);
    __syncthreads();  // row t is read at step t + 1
    OGP_STAMP(k, t, 4);
  }
  // Ut, Rt, Pt whole, for the rebuild of the flat factors
  float* Fb = F + blockIdx.x * kk;
  const long long stride = gridDim.x * kk;
  for (int e = tid; e < kk; e += kCoordThreads) {
    const int i = e / k, l = e - i * k;
    const int at = lower_col(k, l) + i - l;
    const bool in = l <= i;
    Fb[e] = in ? Ut[at] : 0.f;
    Fb[stride + e] = in ? Rt[at] : 0.f;
    Fb[2 * stride + e] = in ? Pt[at] : 0.f;
  }
}

// (c) K1's apply, at rank k: X += (X A^T) U for (X, A) = (L, R), (B, P), on
// the rows L and B hold ((Bd, rows, m); rows = m for the whole chunk): on
// clusters of AC blocks (chunk_apply_cluster_kernel), or by the two tiled
// kernels through T (Bd, 2, rows, k) when AC is 0 (T unused otherwise).
// Returns a cudaError_t, or ogp::kNoCluster.
int chunk_apply(float* L, float* B, const float* R, const float* Pm, const float* U, float* T, int Bd,
                int k, int rows, int m, int AC, cudaStream_t s) {
  if (AC > 0) {
    if (AC > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    const ApplyLayout lay = chunk_apply_layout(k, m, AC);
    return ogp::launch_cluster_grid(chunk_apply_cluster_kernel, AC, dim3(AC, cdiv(rows, kApplyBM), 2 * Bd),
                                    kApplyThreads, lay.floats * static_cast<long long>(sizeof(float)), s, 1, L,
                                    B, R, Pm, U, k, rows, m, lay);
  }
  chunk_apply_t_kernel<<<dim3(cdiv(k, kTileN), cdiv(rows, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, R, Pm, T, k, rows, m);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_apply_x_kernel<<<dim3(cdiv(m, kTileN), cdiv(rows, kTileM), 2 * Bd), kGemmThreads, 0, s>>>(
      L, B, T, U, k, rows, m);
  return static_cast<int>(cudaGetLastError());
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
  return static_cast<int>(rank1_rows(L, B, nullptr, nullptr, p, s2, 1, Bd, m, m, false, s));
}

// K2 on a row shard. L, B: (Bd, rows, m), a shard's rows of each output,
// updated in place; p: (Bd, m), the whole B^T v (summed over the shards);
// s2: (Bd,) scratch. At rows = m this is ogp_rank1_apply.
int ogp_rank1_apply_rows(float* L, float* B, const float* p, float* s2, int Bd, int rows, int m,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rank1_prepass_kernel<<<Bd, 256, 0, s>>>(p, s2, m);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(rank1_rows(L, B, nullptr, nullptr, p, s2, 1, Bd, rows, m, false, s));
}

// Dynamic shared memory of one block of the cluster recursions (K1's, and
// K5 sub's at G = 1) on G clusters of C blocks per output, in bytes.
long long ogp_chunk_cluster_smem(int k, int m, int C, int G) {
  return chunk_cluster_layout(k, m, C, G).floats * static_cast<long long>(sizeof(float));
}

// Clusters of C blocks of K1's grid recursion kernel at (k, m, G) that the
// card holds at once, or minus a cudaError_t.
int ogp_chunk_grid_capacity(int k, int m, int C, int G) {
  return ogp::cluster_capacity(chunk_recursion_grid_kernel, C, kClusterThreads, ogp_chunk_cluster_smem(k, m, C, G));
}

// Dynamic shared memory of one block of K1's spread recursion on G
// clusters of C blocks per output with `slices` factor slices in shared
// memory (3, 1 or 0), in bytes.
long long ogp_chunk_spread_smem(int k, int m, int C, int G, int slices) {
  return chunk_cluster_layout(k, m, C, G, slices).floats * static_cast<long long>(sizeof(float));
}

// Clusters of C blocks of K1's spread recursion kernel at (k, m, G, slices)
// that the card holds at once, or minus a cudaError_t.
int ogp_chunk_spread_capacity(int k, int m, int C, int G, int slices) {
  const SpreadKernel kernel = spread_kernel(slices);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return ogp::cluster_capacity(kernel, C, kClusterThreads, ogp_chunk_spread_smem(k, m, C, G, slices));
}

// K1. L, B: (Bd, m, m), updated in place; idx: (k, P) int32, shared by the
// outputs; wv: (Bd, k, P); p0, U, Pm, R: (Bd, k, m) scratch; T: (Bd, 2, m, k)
// scratch of the tiled apply (unused when AC > 0); slots: (Bd, 2, G, k + 1)
// zeroed words of the recursion on G > 1 clusters or spread (else unused).
// The recursion runs as chunk_recursion runs it: spread over G clusters of
// C blocks per output with `spread` slices in shared memory when
// spread >= 0, else on G clusters of C blocks per output (in waves of
// `wave` outputs when G > 1; G = 1: the carried kernel); the apply on
// clusters of AC blocks, or on the tiled kernels when AC is 0.
// Returns cudaGetLastError() after the launches, or -1 when the card cannot
// hold a wave's clusters of C blocks (or one of AC).
int ogp_blocked_chunk(float* L, float* B, const int* idx, const float* wv, float* p0,
                      float* U, float* Pm, float* R, float* T, unsigned long long* slots, int Bd, int k,
                      int P, int m, int G, int wave, int AC, int C, int spread, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(B, idx, wv, p0, k, P, m, m, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = chunk_recursion(p0, U, Pm, R, Bd, k, m, C, G, wave, spread, slots, s);
  if (rc != 0) return rc;
  return chunk_apply(L, B, R, Pm, U, T, Bd, k, m, m, AC, s);
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
  return static_cast<int>(rank1_rows(L, B, A, v, p, s2, tiles, Bd, m, m, true, s));
}

// K5 sub on a cluster of C blocks per output (C <= 8), the chunk's
// arguments as K1's (p0, U, Pm, R: (Bd, k, m); T: (Bd, 2, m, k)): one
// gather, chunk_sub_cluster_kernel, one apply at rank k (on clusters of AC
// blocks, or tiled when AC is 0). Returns cudaGetLastError() after the
// launches, or -1 when no cluster of C (AC) blocks fits on the card.
int ogp_blocked_chunk_sub_cluster(float* L, float* B, const int* idx, const float* wv, float* p0,
                                  float* U, float* Pm, float* R, float* T, int Bd, int k, int sub,
                                  int P, int m, int AC, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || C > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  chunk_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(B, idx, wv, p0, k, P, m, m, 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const ChunkClusterLayout lay = chunk_cluster_layout(k, m, C);
  const int rc = ogp::launch_cluster(chunk_sub_cluster_kernel, C, Bd,
                                     lay.floats * static_cast<long long>(sizeof(float)), s, p0, U,
                                     Pm, R, k, sub, m, lay);
  if (rc != 0) return rc;
  return chunk_apply(L, B, R, Pm, U, T, Bd, k, m, m, AC, s);
}

// K5 sub outside its fused kernel's shapes, one sub-block at a time.
// L, B: (Bd, m, m), updated in place; idx: (k, P) int32; wv:
// (nb, Bd, sub, P) with nb = k / sub; q, U, Pm, R: (nb, Bd, sub, m) scratch;
// a2: (Bd, sub, sub) and T: (Bd, 2, m, sub) scratch; slots:
// (nb, Bd, 2, G, sub + 1) zeroed words when G > 1 or spread. Each
// sub-block's recursion runs as K1's at k = sub (chunk_recursion: spread
// with `spread` slices in shared memory when spread >= 0, else on G
// clusters of C blocks per output in waves of `wave` outputs, by the
// carried kernel where G = 1), its apply (at rank sub) on clusters of AC
// blocks (AC = 0: tiled).
int ogp_blocked_chunk_sub(float* L, float* B, const int* idx, const float* wv, float* q,
                          float* U, float* Pm, float* R, float* a2, float* T, unsigned long long* slots,
                          int Bd, int k, int sub, int P, int m, int G, int wave, int AC, int C, int spread,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = k / sub;
  const long long mm = m, rows = (long long)sub * m, blk = Bd * rows;
  const long long words = G > 1 || spread >= 0 ? Bd * 2LL * G * (sub + 1) : 0;
  cudaError_t e;
  // every sub-block's raw rows come from B before the chunk changes it
  for (int j = 0; j < nb; ++j) {
    chunk_gather_kernel<<<dim3(sub, Bd), 256, 0, s>>>(B, idx + (long long)j * sub * P,
                                                      wv + (long long)j * Bd * sub * P,
                                                      q + j * blk, sub, P, m, m, 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int j = 0; j < nb; ++j) {
    float* qj = q + j * blk;
    for (int i = 0; i < j; ++i) {
      // a2 = q_j P_i^T, then q_j += a2 U_i
      e = gemm(sub, sub, m, MatArg{qj, mm, 1, rows, 1, kEveryBatch},
               MatArg{Pm + i * blk, 1, mm, rows, 1, kEveryBatch}, a2, sub, (long long)sub * sub, Bd,
               1.f, false, s);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = gemm(sub, m, sub, MatArg{a2, sub, 1, (long long)sub * sub, 1, kEveryBatch},
               MatArg{U + i * blk, mm, 1, rows, 1, kEveryBatch}, qj, mm, rows, Bd, 1.f, true, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int rc = chunk_recursion(qj, U + j * blk, Pm + j * blk, R + j * blk, Bd, sub, m, C, G, wave, spread,
                                   words ? slots + j * words : nullptr, s);
    if (rc != 0) return rc;
  }
  for (int j = 0; j < nb; ++j) {
    const int rc = chunk_apply(L, B, R + j * blk, Pm + j * blk, U + j * blk, T, Bd, sub, m, m, AC, s);
    if (rc != 0) return rc;
  }
  return 0;
}

// Dynamic shared memory of the K5 coord recursion kernel, in bytes.
long long ogp_blocked_chunk_coord_smem(int k) {
  return coord_floats(k) * static_cast<long long>(sizeof(float));
}

// Partials of M a K5 coord chunk's scratch Mg holds: (Bd, splits, k, k).
int ogp_blocked_chunk_coord_splits() { return kGramSplit; }

// K5 coord. L, B: (Bd, m, m), updated in place; idx: (k, P) int32; wv:
// (Bd, k, P); p0: (Bd, k, m), Mg: (Bd, splits, k, k), F: (3, Bd, k, k),
// X: (3, Bd, k, m), T: (Bd, 2, m, k) scratch; the apply on clusters of AC
// blocks, or tiled when AC is 0.
int ogp_blocked_chunk_coord(float* L, float* B, const int* idx, const float* wv, float* p0,
                            float* Mg, float* F, float* X, float* T, int Bd, int k, int P, int m,
                            int AC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mm = m, km = (long long)k * m, kk = (long long)k * k;
  chunk_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(B, idx, wv, p0, k, P, m, m, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = cdiv(k, kGramTile);
  coord_gram_kernel<<<dim3(nt * (nt + 1) / 2, kGramSplit, Bd), kGramTile * kGramTile, 0, s>>>(p0, Mg, k,
                                                                                              m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long smem = ogp_blocked_chunk_coord_smem(k);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(coord_recursion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  coord_recursion_kernel<<<Bd, kCoordThreads, smem, s>>>(Mg, F, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the flat factors X[w, b] = F[w, b] P0[b]: U = Ut P0, R = Rt P0, P = Pt P0
  e = gemm(k, m, k, MatArg{F, k, 1, kk, 1, kEveryBatch}, MatArg{p0, mm, 1, km, 1, Bd}, X, mm, km,
           3 * Bd, 1.f, false, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long bkm = Bd * km;
  return chunk_apply(L, B, X + bkm, X + 2 * bkm, X, T, Bd, k, m, m, AC, s);
}

// K1's three stages as entries of their own, for a chunk whose roots are
// row-sharded over several processes (online_gp_torch/parallel/mesh.py::
// sharded_stream_blocked, the port of mesh.py's shard_map body): each
// process gathers its partial p0 from its rows, the partials are summed
// across the processes (torch.distributed all_reduce), every process runs
// the recursion on the sum, and each applies the factors to its own rows.
// The kernels are K1's own (chunk_gather_kernel, the recursion kernels,
// the apply's), launched as ogp_blocked_chunk launches them.

// The gather over a row shard. B: (Bd, rows, m), rows [row0, row0 + rows) of
// each output's inverse root; idx: (k, P) int32 in [0, m); wv: (Bd, k, P);
// p0: (Bd, k, m) out, the partial p0 of these rows.
int ogp_chunk_gather_rows(const float* B, const int* idx, const float* wv, float* p0, int Bd, int k,
                          int P, int rows, int m, int row0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(B, idx, wv, p0, k, P, rows, m, row0);
  return static_cast<int>(cudaGetLastError());
}

// The recursion on the summed p0: (Bd, k, m) in; U, Pm, R: (Bd, k, m) out;
// slots: (Bd, 2, G, k + 1) zeroed words when G > 1 or spread. Run as
// chunk_recursion runs it: spread over G clusters of C blocks per output
// with `spread` slices in shared memory when spread >= 0, else on G
// clusters of C blocks per output in waves of `wave` outputs, by the
// carried kernel where G = 1. Returns cudaGetLastError(), or -1 when the
// card cannot hold a wave's clusters.
int ogp_chunk_factors(const float* p0, float* U, float* Pm, float* R, unsigned long long* slots, int Bd, int k,
                      int m, int G, int wave, int C, int spread, void* stream) {
  return chunk_recursion(p0, U, Pm, R, Bd, k, m, C, G, wave, spread, slots, static_cast<cudaStream_t>(stream));
}

// The apply on a row shard: L, B: (Bd, rows, m), updated in place; R, Pm,
// U: (Bd, k, m); T: (Bd, 2, rows, k) scratch of the tiled apply. On
// clusters of AC blocks, or tiled when AC is 0; returns cudaGetLastError(),
// or -1 when no cluster of AC blocks fits on the card.
int ogp_chunk_apply_rows(float* L, float* B, const float* R, const float* Pm, const float* U,
                         float* T, int Bd, int k, int rows, int m, int AC, void* stream) {
  return chunk_apply(L, B, R, Pm, U, T, Bd, k, rows, m, AC, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block of K1's apply on clusters of C
// blocks, in bytes (chunk_apply_layout).
long long ogp_chunk_apply_smem(int k, int m, int C) {
  return chunk_apply_layout(k, m, C).floats * static_cast<long long>(sizeof(float));
}

}  // extern "C"
