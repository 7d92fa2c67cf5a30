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
//   (b) recursion, on a thread-block cluster: C = 8 blocks per output (the
//       portable cluster size), or 16 (the largest an H100 takes, a
//       non-portable size) where 8 blocks cannot hold the slices, block r
//       owning columns [r W, r W + W), W = cdiv(m, C), with its columns of Z
//       (k rows) in its own shared
//       memory. a and s_t . ct are P-sparse (P = 4^D), so a step has one
//       O(t m) pass, local to each block, and one exchange. Step t:
//         1. ct = c0w[t] - Z^T a on the slice (a of step t, the same in
//            every block).
//         2. The block's partials over the stencil entries in its own
//            columns, pushed to every block (ogp::Exchange, st.async):
//            pv_t = s_t . ct, and a of step t + 1 (s_{t+1} . Z_j for
//            j < t, s_{t+1} . ct for row t, unscaled).
//         3. Every block adds the C partials in rank order: a of step
//            t + 1 and pv_t; then pm_t = mu0w[t] + r . a (r . a formed
//            before the wait), inv = rsqrt(max(pv_t + nz_t, 1e-20)), r_t.
//         4. Z[t] = ct inv on the slice; row t of the next a times inv.
//       Each block reads only its own shared memory: a step's 16 stencil
//       entries lie in one or two blocks' columns, so reading them from
//       their owners over DSMEM would queue the whole cluster's reads on
//       those one or two SMs. Z goes to the scratch of the apply after the
//       last step. Shapes whose slice, stencil and vectors do not fit a
//       block of 8 (m > 3,136 at k = 128, P = 16) run on 16 blocks (C = 16
//       at m = 4,096: 170.6 KB a block, one a SM, so one cluster takes 16
//       SMs of a GPC; the step's exchange then fans out to 16 blocks), and
//       those that do not fit a block of 16 either (m > 6,016 at k = 128,
//       k > 342 at m = 900) run spread over the card
//       (pred_recursion_spread_kernel): as many clusters of 8 as the card
//       holds at once, up to 16, each step's sums added within each cluster
//       in rank order, then across the clusters in cluster order through
//       device memory (ogp::GridExchange), each block keeping its slice of Z
//       and its stencil entries in shared memory where they fit, else the
//       stencil entries alone (Z's rows in the output Z), else neither (the
//       entries read from idx and wv, in the same order): the step's
//       column pass runs on 120 SMs, not one.
//       The rule is by shape and the card's capacity: pred_cluster_plan and
//       pred_spread_plan in online_gp_torch/ops/cuda_pred_stream.py,
//       mirroring pred_cluster_layout below (the wrapper checks the two
//       agree).
//   (c) apply: C -= Z^T Z in place, with mu += Z^T r fused into the blocks
//       of the first tile column (pred_apply128_kernel, pred_apply64_kernel).
//       Bound by operations: 2 rows m k flops against 2 rows m floats of C
//       in and out (0.032 ms of f32 FMA at m = 4,096 and 2,048 rows on an
//       H100, 0.020 ms of bytes). It replaces the port's first design, 64 x 64 tiles of
//       ogp::gemm_tile with scalar loads and two barriers a depth-16 step:
//       a block owns a 128 x 128 tile of C (64 x 128 where 128-row tiles
//       would leave SMs idle, a rule by shape: pred_apply_plan in
//       ops/cuda_pred_stream.py), each thread an 8 x 8 (4 x 8) block of it
//       fed by 16-byte shared loads; the rows of Z stream through a
//       three-slot cp.async ring of 16 rows, neither operand transposed
//       (both are rows of Z); C's tile is prefetched to L2 during the loop
//       and read and written with 16-byte accesses. The k sum is not split:
//       each entry is the same fmaf chain, in the same order, as before, so
//       a chunk's results are bitwise those of the first design.
//   The three stages are also C entries of their own (ogp_pred_gather_rows,
//   ogp_pred_factors, ogp_pred_apply_rows) for caches row-sharded over
//   processes: the gather and the apply then run over a shard's rows
//   [row0, row0 + rows) of C and mu, the recursion on the summed c0w and
//   mu0w (the JAX package's sharded_pred_stream_blocked runs the plain
//   pred_chunk_factors there).
// Bound: operations. C is symmetric, so C -= Z^T Z needs m (m + 1) k flops
// (a SYRK) and m (m + 1) / 2 floats of C read and written; with the recursion's
// k^2 m that is 0.12 GFLOP per output at m = 900, k = 128. The apply below
// updates all m^2 entries (the gather reads rows of C as columns, so both
// halves are kept). The recursion is bound by latency: a step is one
// exchange and four block barriers around short shared-memory passes
// (~2.1 us at t = 64 on an H100; cluster_probe.py measures each stage,
// building this file with OGP_STAMPS, common.cuh).
//
// Not carried over from the Pallas design: the VMEM-resident C (it stays in
// device memory) and the (k, m) scratch factors (split over the cluster's
// shared memory); the in-order grid whose first tile ran the recursion
// (three launches here); the padding of m to a 128-lane multiple (the
// kernels mask their own edge).
#include "common.cuh"

using ogp::cdiv;
using ogp::ColSplit;
using ogp::ColTask;
using ogp::col_partials;
using ogp::col_sum;
using ogp::kClusterRegs;
using ogp::kClusterThreads;
using ogp::kClusterWarps;
using ogp::warp_sum;
namespace cg = cooperative_groups;

namespace {

// (a) over the stencil points in [row0, row0 + rows): C holds those rows of
// each output's cache, (Bd, rows, m), and mu those entries, (Bd, rows); the
// whole chunk has row0 = 0, rows = m. grid (k, Bd)
__global__ void pred_gather_kernel(const float* __restrict__ C, const float* __restrict__ mu,
                                   const int* __restrict__ idx, const float* __restrict__ wv,
                                   float* __restrict__ c0w, float* __restrict__ mu0w, int k,
                                   int P, int rows, int m, int row0) {
  const long long t = blockIdx.x, b = blockIdx.y, mm = m, rr = rows;
  const float* Cb = C + b * rr * mm;
  const int* it = idx + t * P;
  const float* wt = wv + t * P;
  float* out = c0w + (b * k + t) * mm;
  for (int l = threadIdx.x; l < m; l += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) {
      const int row = it[q] - row0;
      if ((unsigned)row < (unsigned)rows) acc = fmaf(wt[q], Cb[row * mm + l], acc);
    }
    out[l] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int q = 0; q < P; ++q) {
      const int row = it[q] - row0;
      if ((unsigned)row < (unsigned)rows) acc = fmaf(wt[q], mu[b * rr + row], acc);
    }
    mu0w[b * k + t] = acc;
  }
}

// Shared-memory layout of one block of the cluster recursion;
// pred_cluster_plan (online_gp_torch/ops/cuda_pred_stream.py) mirrors it.
struct PredClusterLayout {
  int C, W;
  ColSplit cs;
  long long floats;
};

// On G clusters of C blocks per output (G > 1: pred_recursion_spread_kernel)
// a block owns W = cdiv(m, C G) columns; its receive buffers stay those of
// its own cluster's C blocks. `slices`: what sits in shared memory beside
// the step's vectors: 2, the block's slice of Z and its stencil entries
// (the cluster kernel's layout); in the spread kernel also 1, the stencil
// entries alone (Z in device memory), or 0, neither (the stencil read from
// idx and wv in device memory).
__host__ __device__ inline PredClusterLayout pred_cluster_layout(int k, int m, int P, int C, int G = 1,
                                                                 int slices = 2) {
  PredClusterLayout lay;
  lay.C = C;
  lay.W = cdiv(m, C * G);
  lay.cs = ogp::col_split(lay.W);
  // two mbarriers; Z slice (slices 2); ct; a (two steps); the receive
  // buffers (two uses of C rows of k + 1); r, mu0w, y, nz; column partials;
  // the chunk's stencil entries in this block (local columns, weights,
  // counts; slices >= 1); inv, r . a
  lay.floats = 4 + (slices == 2 ? static_cast<long long>(k) * lay.W : 0) + lay.W + 2LL * k + 2LL * C * (k + 1) +
               4LL * k + static_cast<long long>(lay.cs.S) * lay.cs.CT * 32 + (slices >= 1 ? 2LL * k * P + k : 0) + 2;
  return lay;
}

// (b) the k-step recursion on a cluster of lay.C blocks per output, grid
// (C, Bd), or, with kGrid, on gx.G clusters of them, grid (C G, Bd), each
// exchange's sums then added across the clusters (GridExchange, in cluster
// order after the rank order within each). kZShared: the block's slice of
// Z in shared memory; else (the spread kernel only) Z's rows stay in the
// output Z in device memory, where the step writes its row anyway and the
// block reads only its own columns. kStencilShared: the block's stencil
// entries staged in shared memory; else (the spread kernel only, where the
// k P entries do not fit beside the rest) read from idx and wv in device
// memory in the same order, so the same sums. The grid branch compiles out
// without kGrid, so the one-cluster kernel keeps its sums' order and bits.
template <bool kGrid, bool kZShared, bool kStencilShared, int kMaxG>
__device__ __forceinline__ void pred_recursion_body(const int* __restrict__ idx, const float* __restrict__ wv,
                                                    const float* __restrict__ c0w, const float* __restrict__ mu0w,
                                                    const float* __restrict__ y, const float* __restrict__ nz,
                                                    float* __restrict__ Z, float* __restrict__ r,
                                                    float* __restrict__ pm, float* __restrict__ pv, int k, int P,
                                                    int m, const PredClusterLayout& lay,
                                                    const ogp::GridExchange& gx) {
  static_assert((kZShared && kStencilShared) || kGrid, "device-memory operands only in the spread kernel");
  static_assert(kStencilShared || !kZShared, "Z in shared memory only beside the stencil");
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = lay.C, W = lay.W;
  const ColSplit cs = lay.cs;
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = ((kGrid ? gx.g * C : 0) + rank) * W;
  const long long b = blockIdx.y, mm = m;
  float* Zb = Z + b * k * mm + c0;
  // k x ldz: this block's columns of Z (in shared memory after two
  // mbarriers, or in the output)
  float* Zs = kZShared ? sh + 4 : Zb;
  const int ldz = kZShared ? W : m;
  float* ct = sh + 4 + (kZShared ? k * W : 0);  // W
  float* a = ct + W;                // 2 x k: a of step t at (t & 1)
  const ogp::Exchange x{reinterpret_cast<unsigned long long*>(sh), a + 2 * k, C, k + 1, rank};
  float* rs = x.recv + 2 * C * (k + 1);  // k: r so far
  float* vec = rs + k;              // 3 k: mu0w, y, nz of this output
  float* red = vec + 3 * k;         // S CT 32: column partials
  int* sloc = reinterpret_cast<int*>(red + cs.S * cs.CT * 32);  // k x P (kStencilShared)
  float* swv = reinterpret_cast<float*>(sloc + k * P);            // k x P
  int* scnt = reinterpret_cast<int*>(swv + k * P);                // k
  float* sc = kStencilShared ? reinterpret_cast<float*>(scnt + k)  // inv, r . a of step t
                             : reinterpret_cast<float*>(sloc);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const ColTask task = ogp::col_task(cs);
  const int w = max(0, min(W, m - c0));
  const float* c0b = c0w + b * k * mm + c0;
  // step t's stencil entries in this block's columns, in stencil order:
  // local column and weight, scnt[t] of them
  for (int t = tid; t < k; t += kClusterThreads) {
    if (kStencilShared) {
      int n = 0;
      for (int q = 0; q < P; ++q) {
        const int col = idx[t * P + q];
        const int l = col - c0;
        if ((unsigned)col < (unsigned)m && l >= 0 && l < w) {
          sloc[t * P + n] = l;
          swv[t * P + n] = wv[t * P + q];
          ++n;
        }
      }
      scnt[t] = n;
    }
    vec[t] = mu0w[b * k + t];
    vec[k + t] = y[b * k + t];
    vec[2 * k + t] = nz[b * k + t];
  }
  float next[kClusterRegs];  // c0w[t + 1] for this thread's columns
#pragma unroll
  for (int i = 0; i < kClusterRegs; ++i) {
    const int l = tid + i * kClusterThreads;
    next[i] = l < w ? c0b[l] : 0.f;
  }
  ogp::exchange_init(x);  // also orders the prologue's shared-memory writes

  for (int t = 0; t < k; ++t) {
    OGP_STAMP(k, t, 0);
    const float* at = a + (t & 1) * k;
    float* an = a + ((t + 1) & 1) * k;
    // 1. ct = c0w[t] - Z^T a on the slice
    col_partials<1>(Zs, nullptr, ldz, at, 1.f, t, w, cs, task, red);
#pragma unroll
    for (int i = 0; i < kClusterRegs; ++i) {
      const int l = tid + i * kClusterThreads;
      if (l < w) ct[l] = next[i] - col_sum(red, 0, l, cs);
      if (l < w && t + 1 < k) next[i] = c0b[(t + 1) * mm + l];
    }
    __syncthreads();
    OGP_STAMP(k, t, 1);
    // 2. this block's partials over its stencil entries, pushed as exchange
    // use t: a_j of step t + 1 for j <= t (row t as ct, unscaled) in slot j,
    // and pv_t = s_t . ct in slot nrows; the last warp forms r . a of step t
    const int nrows = t + 1 < k ? t + 1 : 0;
    ogp::exchange_expect(x, t, nrows + 1);
    for (int j = tid; j <= nrows; j += kClusterThreads) {
      const int tq = j == nrows ? t : t + 1;
      const float* row = j < t && j != nrows ? Zs + j * ldz : ct;
      float s = 0.f;
      if (kStencilShared) {
        const int* lq = sloc + tq * P;
        const float* wq = swv + tq * P;
        for (int q = 0; q < scnt[tq]; ++q) s = fmaf(wq[q], row[lq[q]], s);
      } else {
        for (int q = 0; q < P; ++q) {
          const int col = idx[tq * P + q];
          const int l = col - c0;
          if ((unsigned)col < (unsigned)m && l >= 0 && l < w) s = fmaf(wv[tq * P + q], row[l], s);
        }
      }
      ogp::exchange_push(x, t, j, s);
    }
    if ((tid >> 5) == kClusterWarps - 1) {
      float ra = 0.f;
      for (int j = lane; j < t; j += 32) ra = fmaf(rs[j], at[j], ra);
      ra = warp_sum(ra);
      if (lane == 0) sc[1] = ra;
    }
    __syncthreads();  // r . a is read below
    OGP_STAMP(k, t, 2);
    ogp::exchange_wait(x, t);
    OGP_STAMP(k, t, 3);
    // 3. the partials of all blocks, added in rank order; with pv_t:
    // pm_t = mu0w[t] + r . a, inv = rsqrt(max(pv_t + nz_t, 1e-20)), r_t
    for (int j = tid; j <= nrows; j += kClusterThreads) {
      float v = ogp::exchange_sum(x, t, j);
      if (kGrid) v = ogp::grid_sum<kMaxG>(gx, t, j, v);
      if (j < nrows) {
        an[j] = v;
        continue;
      }
      const float pmv = vec[t] + sc[1];
      const float inv = rsqrtf(fmaxf(v + vec[2 * k + t], 1e-20f));
      const float rt = (vec[k + t] - pmv) * inv;
      rs[t] = rt;
      sc[0] = inv;
      if (rank == 0 && (!kGrid || gx.g == 0)) {
        r[b * k + t] = rt;
        pm[b * k + t] = pmv;
        pv[b * k + t] = v;
      }
    }
    __syncthreads();
    OGP_STAMP(k, t, 4);
    // 4. Z[t] = ct inv on the slice; a_t of step t + 1 gets its inv
    const float inv = sc[0];
    for (int l = tid; l < w; l += kClusterThreads) Zs[t * ldz + l] = ct[l] * inv;
    if (tid == 0 && t + 1 < k) an[t] *= inv;
    __syncthreads();
    OGP_STAMP(k, t, 5);
  }
  // the slice in shared memory goes to the scratch of the apply once,
  // after the last step
  if (kZShared) {
    for (int e = tid; e < k * w; e += kClusterThreads) {
      const int j = e / w, l = e - j * w;
      Zb[j * mm + l] = Zs[j * W + l];
    }
  }
  cluster.sync();  // no block leaves while a push to another may be in flight
}

// (b) on a cluster of lay.C blocks per output, grid (C, Bd).
__global__ void __launch_bounds__(kClusterThreads)
pred_recursion_cluster_kernel(const int* __restrict__ idx, const float* __restrict__ wv,
                              const float* __restrict__ c0w, const float* __restrict__ mu0w,
                              const float* __restrict__ y, const float* __restrict__ nz,
                              float* __restrict__ Z, float* __restrict__ r, float* __restrict__ pm,
                              float* __restrict__ pv, int k, int P, int m, PredClusterLayout lay) {
  pred_recursion_body<false, true, true, 1>(idx, wv, c0w, mu0w, y, nz, Z, r, pm, pv, k, P, m, lay,
                                             ogp::GridExchange{});
}

// (b) spread over the card: past what one cluster of 16 holds (m > 6,016
// at k = 128, P = 16; k > 342 at m = 900), G <= 16 clusters of lay.C
// blocks per output, as many as the card holds at once (pred_spread_plan in
// ops/cuda_pred_stream.py), grid (C G, Bd), the block's slice of Z and its
// stencil entries in shared memory where they fit (kSlices 2), else the
// stencil entries alone (1, Z in the output), else neither (0). slots:
// (Bd, 2, G, k + 1) zeroed words, output b's at slots[b].
template <int kSlices>
__global__ void __launch_bounds__(kClusterThreads)
pred_recursion_spread_kernel(const int* __restrict__ idx, const float* __restrict__ wv,
                             const float* __restrict__ c0w, const float* __restrict__ mu0w,
                             const float* __restrict__ y, const float* __restrict__ nz, float* __restrict__ Z,
                             float* __restrict__ r, float* __restrict__ pm, float* __restrict__ pv, int k, int P,
                             int m, PredClusterLayout lay, int G, unsigned long long* __restrict__ slots) {
  const ogp::GridExchange gx{slots + blockIdx.y * (2LL * G * (k + 1)), G, k + 1,
                             static_cast<int>(blockIdx.x) / lay.C, cg::this_cluster().block_rank() == 0};
  pred_recursion_body<true, (kSlices == 2), (kSlices >= 1), ogp::kMaxSpreadClusters>(idx, wv, c0w, mu0w, y, nz, Z, r,
                                                                                  pm, pv, k, P, m, lay, gx);
}

using PredSpreadKernel = void (*)(const int*, const float*, const float*, const float*, const float*,
                                 const float*, float*, float*, float*, float*, int, int, int, PredClusterLayout,
                                 int, unsigned long long*);

// The spread kernel with `slices` (2: Z and the stencil in shared memory,
// 1: the stencil alone, 0: neither), or null for any other count.
PredSpreadKernel pred_spread_kernel(int slices) {
  switch (slices) {
    case 2: return pred_recursion_spread_kernel<2>;
    case 1: return pred_recursion_spread_kernel<1>;
    case 0: return pred_recursion_spread_kernel<0>;
    default: return nullptr;
  }
}

// (b) for Bd outputs: spread over G clusters of C blocks per output with
// `spread` of Z and the stencil in shared memory (2, 1 or 0) when
// spread >= 0, in waves
// of `wave` outputs, each checked to fit the card at once (slots: (Bd, 2, G,
// k + 1) zeroed words); else on one cluster of C blocks per output. Returns
// a cudaError_t, or ogp::kNoCluster.
int pred_recursion(const int* idx, const float* wv, const float* c0w, const float* mu0w,
                   const float* y, const float* nz, float* Z, float* r, float* pm, float* pv,
                   int Bd, int k, int P, int m, int C, int G, int wave, int spread, unsigned long long* slots,
                   cudaStream_t s) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (spread >= 0) {
    const PredSpreadKernel kernel = pred_spread_kernel(spread);
    if (kernel == nullptr || G < 1 || G > ogp::kMaxSpreadClusters || wave < 1 || slots == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const PredClusterLayout lay = pred_cluster_layout(k, m, P, C, G, spread);
    const long long smem = lay.floats * static_cast<long long>(sizeof(float));
    const long long km = static_cast<long long>(k) * m, words = 2LL * G * (k + 1);
    for (int b0 = 0; b0 < Bd; b0 += wave) {
      const int nb = Bd - b0 < wave ? Bd - b0 : wave;
      const int rc = ogp::launch_cluster_grid(kernel, C, dim3(C * G, nb, 1), kClusterThreads, smem, s, nb * G, idx,
                                              wv, c0w + b0 * km, mu0w + b0 * k, y + b0 * k, nz + b0 * k,
                                              Z + b0 * km, r + b0 * k, pm + b0 * k, pv + b0 * k, k, P, m, lay, G,
                                              slots + b0 * words);
      if (rc != 0) return rc;
    }
    return 0;
  }
  const PredClusterLayout lay = pred_cluster_layout(k, m, P, C);
  return ogp::launch_cluster(pred_recursion_cluster_kernel, C, Bd,
                             lay.floats * static_cast<long long>(sizeof(float)), s, idx, wv,
                             c0w, mu0w, y, nz, Z, r, pm, pv, k, P, m, lay);
}

// (c) the apply. A block owns a BM x kPredBN tile of C (BM = 128, or 64
// where 128-row tiles would not give every SM a block: pred_apply_plan in
// ops/cuda_pred_stream.py); the rows of Z feeding it, Z[t][row0 + i] and
// Z[t][j], stream through a ring of kPredStages cp.async slots of kPredKT
// rows each. Both operands are rows of Z, contiguous along m, so each
// thread's 16-byte shared loads feed an 8 x 8 (BM = 128) or 4 x 8 outer
// product a row of Z with no transpose.
constexpr int kPredBN = 128;     // columns of C a block owns
constexpr int kPredKT = 16;      // rows of Z a ring slot holds
constexpr int kPredStages = 3;
constexpr int kPredThreads = 256;

// Dynamic shared memory of the apply at BM-row tiles, in floats.
__host__ __device__ inline long long pred_apply_floats(int bm) {
  return static_cast<long long>(kPredStages) * kPredKT * (bm + kPredBN);
}

// C[b] -= Z[b][:, rows]^T Z[b] in place on the rows [row0, row0 + rows) C
// holds, (Bd, rows, m) (row0 = 0, rows = m for the whole chunk); the first
// tile column also does mu[b] += Z[b][:, rows]^T r[b] for its rows.
// grid (column tiles, row tiles, Bd). Thread (ti, tj) owns rows 4 ti +
// [0, 4) (and 64 + 4 ti + [0, 4) at BM = 128) and columns 4 tj + [0, 4) and
// 64 + 4 tj + [0, 4); a warp's eight tj read 128 contiguous bytes. Each
// entry is an fmaf chain over t = 0, 1, ..., padded with zero rows to a
// multiple of kPredKT, then C - chain: the same sums, in the same order, as
// the tiled GEMM (ogp::gemm_tile) this replaces, so results are bitwise
// the same.
template <int BM>
__device__ __forceinline__ void pred_apply_tile(float* C, float* mu, const float* Z, const float* r, int k,
                                                int rows, int m, int row0) {
  static_assert(BM == 64 || BM == 128, "tiles of 64 or 128 rows");
  constexpr int kI = BM / 16;  // rows a thread owns
  constexpr int kSlot = kPredKT * (BM + kPredBN);
  extern __shared__ __align__(16) float apply_sh[];
  const long long b = blockIdx.z, mm = m, rr = rows;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * kPredBN;
  const int nA = min(BM, rows - i0), nB = min(kPredBN, m - j0), nK = cdiv(k, kPredKT);
  const float* Zb = Z + b * k * mm;
  const float* Za = Zb + row0 + i0;  // Z(t, row0 + i0 + i)
  const float* Zc = Zb + j0;         // Z(t, j0 + j)
  float* Cb = C + (b * rr + i0) * mm + j0;
  const bool vecA = ((m | row0) & 3) == 0, vecC = (m & 3) == 0;

  // the tile of C is read only after the loop: have it on its way to L2
  for (int e = threadIdx.x; e < BM * (kPredBN / 32); e += kPredThreads) {
    const int i = e / (kPredBN / 32), q = e - i * (kPredBN / 32);
    if (i < nA && 32 * q < nB)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(Cb + i * mm + 32 * q));
  }
  auto issue = [&](int st) {
    float* As = apply_sh + (st % kPredStages) * kSlot;
    const int t0 = st * kPredKT;
    ogp::tile_async(As, BM, false, Za + t0 * mm, mm, kPredKT, BM / 4, k - t0, nA, vecA, Z);
    ogp::tile_async(As + kPredKT * BM, kPredBN, false, Zc + t0 * mm, mm, kPredKT, kPredBN / 4, k - t0, nB,
                    vecC, Z);
  };
#pragma unroll
  for (int st = 0; st < kPredStages - 1; ++st) {
    if (st < nK) issue(st);
    ogp::cp_async_commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ti = (lane >> 3) + 4 * (warp >> 1);
  const int tj = (lane & 7) + 8 * (warp & 1);
  float acc[kI][8];
#pragma unroll
  for (int a = 0; a < kI; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  for (int st = 0; st < nK; ++st) {
    ogp::cp_async_wait<kPredStages - 2>();
    __syncthreads();  // slot st arrived; every thread is done with slot st - 1
    if (st + kPredStages - 1 < nK) issue(st + kPredStages - 1);
    ogp::cp_async_commit();
    const float* As = apply_sh + (st % kPredStages) * kSlot;
    const float* Bs = As + kPredKT * BM;
#pragma unroll
    for (int t = 0; t < kPredKT; ++t) {
      float av[kI], bv[8];
#pragma unroll
      for (int h = 0; h < kI / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(As + t * BM + 64 * h + 4 * ti);
        av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z, av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + t * kPredBN + 64 * h + 4 * tj);
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z, bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < kI; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
  }
  ogp::cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < kI; ++a) {
    const int i = 64 * (a / 4) + 4 * ti + (a & 3);
    if (i >= nA) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 64 * h + 4 * tj;
      if (j >= nB) continue;
      float* out = Cb + i * mm + j;
      if (vecC) {
        float4 c = *reinterpret_cast<float4*>(out);
        c.x = c.x - acc[a][4 * h];
        c.y = c.y - acc[a][4 * h + 1];
        c.z = c.z - acc[a][4 * h + 2];
        c.w = c.w - acc[a][4 * h + 3];
        *reinterpret_cast<float4*>(out) = c;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < nB) out[q] = out[q] - acc[a][4 * h + q];
      }
    }
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < nA; i += kPredThreads) {
      const int row = i0 + i;
      float s = 0.f;
      for (int t = 0; t < k; ++t) s = fmaf(Zb[t * mm + row0 + row], r[b * k + t], s);
      mu[b * rr + row] += s;
    }
  }
}

// The two tile heights as kernels of their own names (the profiler's).
__global__ void __launch_bounds__(kPredThreads)
pred_apply128_kernel(float* C, float* mu, const float* Z, const float* r, int k, int rows, int m, int row0) {
  pred_apply_tile<128>(C, mu, Z, r, k, rows, m, row0);
}

__global__ void __launch_bounds__(kPredThreads)
pred_apply64_kernel(float* C, float* mu, const float* Z, const float* r, int k, int rows, int m, int row0) {
  pred_apply_tile<64>(C, mu, Z, r, k, rows, m, row0);
}

// (c) on Bd outputs at BM-row tiles (64 or 128). Returns a cudaError_t.
int pred_apply(float* C, float* mu, const float* Z, const float* r, int Bd, int k, int rows, int m,
               int row0, int BM, cudaStream_t s) {
  if (BM != 64 && BM != 128) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(m, kPredBN), cdiv(rows, BM), Bd);
  const size_t smem = pred_apply_floats(BM) * sizeof(float);  // <= 48 KB: no attribute needed
  if (BM == 128)
    pred_apply128_kernel<<<grid, kPredThreads, smem, s>>>(C, mu, Z, r, k, rows, m, row0);
  else
    pred_apply64_kernel<<<grid, kPredThreads, smem, s>>>(C, mu, Z, r, k, rows, m, row0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the cluster recursion, in bytes.
long long ogp_pred_cluster_smem(int k, int m, int P, int C) {
  return pred_cluster_layout(k, m, P, C).floats * static_cast<long long>(sizeof(float));
}

// Clusters of C blocks of the cluster recursion at (k, m, P) that the card
// holds at once, or minus a cudaError_t.
int ogp_pred_cluster_capacity(int k, int m, int P, int C) {
  return ogp::cluster_capacity(pred_recursion_cluster_kernel, C, kClusterThreads, ogp_pred_cluster_smem(k, m, P, C));
}

// Dynamic shared memory of one block of the spread recursion on G clusters
// of C blocks per output, with `slices` of Z and the stencil in shared
// memory (2, 1 or 0), in bytes.
long long ogp_pred_spread_smem(int k, int m, int P, int C, int G, int slices) {
  return pred_cluster_layout(k, m, P, C, G, slices).floats * static_cast<long long>(sizeof(float));
}

// Clusters of C blocks of the spread recursion at (k, m, P, G, slices) that
// the card holds at once, or minus a cudaError_t.
int ogp_pred_spread_capacity(int k, int m, int P, int C, int G, int slices) {
  const PredSpreadKernel kernel = pred_spread_kernel(slices);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return ogp::cluster_capacity(kernel, C, kClusterThreads, ogp_pred_spread_smem(k, m, P, C, G, slices));
}

// K3. C: (Bd, m, m) and mu: (Bd, m), updated in place; idx: (k, P) int32 and
// wv: (k, P), shared by the outputs; y, nz: (Bd, k); c0w, Z: (Bd, k, m)
// scratch; mu0w, r: (Bd, k) scratch; pm, pv: (Bd, k) outputs; slots:
// (Bd, 2, G, k + 1) zeroed words of the spread recursion (else unused). The
// recursion runs spread over G clusters of Cl blocks per output with
// `spread` of Z and the stencil in shared memory when spread >= 0 (in waves of
// `wave` outputs), else on clusters of Cl blocks; the apply on tiles of AM
// rows (64 or 128).
// Returns cudaGetLastError() after the launches, or -1 when the card
// cannot hold the clusters of a launch.
int ogp_pred_chunk(float* C, float* mu, const int* idx, const float* wv, const float* y,
                   const float* nz, float* c0w, float* mu0w, float* Z, float* r, float* pm,
                   float* pv, unsigned long long* slots, int Bd, int k, int P, int m, int AM, int Cl, int G,
                   int wave, int spread, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pred_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(C, mu, idx, wv, c0w, mu0w, k, P, m, m, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = pred_recursion(idx, wv, c0w, mu0w, y, nz, Z, r, pm, pv, Bd, k, P, m, Cl, G, wave, spread, slots, s);
  if (rc != 0) return rc;
  return pred_apply(C, mu, Z, r, Bd, k, m, m, 0, AM, s);
}

// K3's three stages as entries of their own, for caches row-sharded over
// several processes (online_gp_torch/parallel/mesh.py::
// sharded_pred_stream_blocked): each process gathers its partial c0w and
// mu0w from its rows, the partials are summed across the processes, every
// process runs the recursion on the sums, and each applies Z to its rows.

// The gather over a row shard. C: (Bd, rows, m) and mu: (Bd, rows), rows
// [row0, row0 + rows) of each output's caches; idx, wv: (k, P); c0w:
// (Bd, k, m) and mu0w: (Bd, k) out, the partials of these rows.
int ogp_pred_gather_rows(const float* C, const float* mu, const int* idx, const float* wv, float* c0w,
                         float* mu0w, int Bd, int k, int P, int rows, int m, int row0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pred_gather_kernel<<<dim3(k, Bd), 256, 0, s>>>(C, mu, idx, wv, c0w, mu0w, k, P, rows, m, row0);
  return static_cast<int>(cudaGetLastError());
}

// The recursion on the summed c0w (Bd, k, m) and mu0w (Bd, k), with the
// whole stencil idx, wv (k, P) and y, nz (Bd, k): Z (Bd, k, m), r, pm, pv
// (Bd, k) out; slots as ogp_pred_chunk's. Spread (spread >= 0) or on
// clusters of Cl blocks, as ogp_pred_chunk's recursion. Returns cudaGetLastError(), or -1 when the
// card cannot hold the clusters of a launch.
int ogp_pred_factors(const int* idx, const float* wv, const float* c0w, const float* mu0w,
                     const float* y, const float* nz, float* Z, float* r, float* pm, float* pv,
                     unsigned long long* slots, int Bd, int k, int P, int m, int Cl, int G, int wave, int spread,
                     void* stream) {
  return pred_recursion(idx, wv, c0w, mu0w, y, nz, Z, r, pm, pv, Bd, k, P, m, Cl, G, wave, spread, slots,
                        static_cast<cudaStream_t>(stream));
}

// The apply on a row shard: C (Bd, rows, m) and mu (Bd, rows), updated in
// place; Z (Bd, k, m), r (Bd, k); tiles of AM rows (64 or 128).
int ogp_pred_apply_rows(float* C, float* mu, const float* Z, const float* r, int Bd, int k, int rows,
                        int m, int row0, int AM, void* stream) {
  return pred_apply(C, mu, Z, r, Bd, k, rows, m, row0, AM, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the apply at tiles of AM rows, in bytes.
long long ogp_pred_apply_smem(int AM) {
  return pred_apply_floats(AM) * static_cast<long long>(sizeof(float));
}

}  // extern "C"
