// Helpers shared by the port's CUDA kernels: warp and block sums, one
// shared-memory-tiled f32 GEMM tile routine, asynchronous copies into shared
// memory, and what the kernels that run on a thread-block cluster share
// (launch, exchange, column sums).
//
// All math is f32 with FMA; nothing here uses tensor cores (TF32 is off by
// the port's precision policy) and nothing uses wgmma or TMA yet.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace ogp {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the whole block, returned to every thread. `red` is shared
// memory of at least 32 floats. Every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // a previous call's readers are done with `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(s);  // every warp reduces the partials itself
}

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kGemmThreads = 256;

// gemm_tile is the port's first GEMM: scalar global loads, one 64 x 64 tile
// a block, two barriers a depth-16 step. Its callers: batched_gemm_kernel
// (K5's sub-block corrections and coord's factor rebuild, root_update.cu),
// and K1's apply for the shapes chunk_apply_plan sends to the tiled kernels
// (chunk_apply_t_kernel, chunk_apply_x_kernel: k too large for the cluster
// kernel's shared memory). K1's and K3's applies on the main path have
// kernels of their own (chunk_apply_cluster_kernel; pred_apply128_kernel
// and pred_apply64_kernel).
//
// One kTileM x kTileN tile of
//     C(i, j) = [C(i, j) if accumulate] + alpha * sum_l A(i, l) * B(l, j)
// for an M x N output with inner size K, where
//     A(i, l) = A[i * a_rs + l * a_cs],  B(l, j) = B[l * b_rs + j * b_cs],
//     C(i, j) = C[i * c_rs + j],
// so either operand may be read transposed. The tile starts at (row0, col0)
// and the ragged edges are masked. Called by all kGemmThreads threads of the
// block (it synchronises); each thread owns a 4 x 4 block of outputs.
// C may be updated in place: only this block reads or writes its tile of C,
// and C must not overlap A or B.
__device__ __forceinline__ void gemm_tile(
    int M, int N, int K,
    const float* __restrict__ A, long long a_rs, long long a_cs,
    const float* __restrict__ B, long long b_rs, long long b_cs,
    float* C, long long c_rs, float alpha, bool accumulate,
    int row0, int col0) {
  __shared__ float As[kTileK][kTileM + 4];  // As[l][i]
  __shared__ float Bs[kTileK][kTileN + 4];  // Bs[l][j]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int l0 = 0; l0 < K; l0 += kTileK) {
    // neighbouring threads read neighbouring addresses along whichever
    // index of the operand is contiguous
    for (int e = tid; e < kTileM * kTileK; e += kGemmThreads) {
      int i, l;
      if (a_cs == 1) {
        i = e / kTileK;
        l = e % kTileK;
      } else {
        l = e / kTileM;
        i = e % kTileM;
      }
      const int gi = row0 + i, gl = l0 + l;
      As[l][i] = (gi < M && gl < K) ? A[gi * a_rs + gl * a_cs] : 0.f;
    }
    for (int e = tid; e < kTileK * kTileN; e += kGemmThreads) {
      int l, j;
      if (b_cs == 1) {
        l = e / kTileN;
        j = e % kTileN;
      } else {
        j = e / kTileK;
        l = e % kTileK;
      }
      const int gl = l0 + l, gj = col0 + j;
      Bs[l][j] = (gl < K && gj < N) ? B[gl * b_rs + gj * b_cs] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < kTileK; ++l) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[l][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[l][tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = row0 + ty * 4 + r;
    if (gi >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = col0 + tx * 4 + c;
      if (gj >= N) continue;
      float* out = C + gi * c_rs + gj;
      const float v = alpha * acc[r][c];
      *out = accumulate ? *out + v : v;
    }
  }
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- asynchronous copies into shared memory (cp.async) ----
//
// cp_async16 copies 16 bytes (both addresses 16-byte aligned), cp_async4
// 4 bytes; a copy whose `valid` is false reads nothing (src-size 0) and
// zero-fills its destination, so a tile's ragged edge arrives as zeros.
// Copies are grouped by cp_async_commit; cp_async_wait<N> returns when at
// most N of this thread's groups are still in flight (a __syncthreads()
// after it makes every thread's copies visible to the block).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A rows x (4 groups) tile of floats into shared memory, by every thread
// of the block: element (r, c) = src[r ld + c] when r < nr and c < nc, else
// 0. Row r of the tile starts at dst + r ld_dst; its 16-byte group g sits at
// group g ^ (r & 7) when swz (ld_dst then a multiple of 32), so that a
// warp's 16-byte loads of one group of eight consecutive rows hit eight
// distinct bank quads. With vec, src and ld are 16-byte aligned and nc is a
// multiple of 4 (one 16-byte copy a group); else four 4-byte copies.
// `any` is an address the copies may name when they read nothing.
__device__ __forceinline__ void tile_async(float* dst, int ld_dst, bool swz, const float* src,
                                           long long ld, int rows, int groups, int nr, int nc,
                                           bool vec, const float* any) {
  for (int e = threadIdx.x; e < rows * groups; e += blockDim.x) {
    const int r = e / groups, g = e - r * groups;
    float* d = dst + r * ld_dst + ((swz ? g ^ (r & 7) : g) << 2);
    const float* s = src + r * ld + 4 * g;
    if (vec) {
      const bool ok = r < nr && 4 * g < nc;
      cp_async16(d, ok ? s : any, ok);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = r < nr && 4 * g + q < nc;
        cp_async4(d + q, ok ? s + q : any, ok);
      }
    }
  }
}

// ---- programmatic dependent launch (PDL) ----
//
// A kernel launched by launch(..., pdl = true) may be scheduled while the
// kernel before it on the stream still runs, once every block of that one
// has called pdl_trigger() (or exited). pdl_wait() returns when the kernel
// before has completed and its writes are visible, so a kernel calls it
// before it reads what the one before wrote, or writes what that one reads.
// Both are no-ops in a kernel launched without the attribute. The
// dependency is transitive: a kernel cannot complete before its own wait.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;" ::: "memory"); }

// kernel<<<grid, block, smem, s>>>(args...), with programmatic stream
// serialization when pdl is true. Returns the launch's cudaError_t.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                   bool pdl, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ---- recursions on a thread-block cluster (K1, K3) ----
//
// One output's m columns are split over the C blocks of a cluster: block r
// owns columns [r W, r W + w), W = cdiv(m, C), and keeps them of the
// recursion's factor rows in its own shared memory. Cross-block sums go
// through distributed shared memory (DSMEM): see Exchange. Past what one
// cluster holds, K1 splits the columns over G clusters (W = cdiv(m, C G),
// block r of cluster g owning [(g C + r) W, ...)) and adds the clusters'
// sums through device memory: see GridExchange. The recursions spread over
// the card (K1's and K3's past their cluster plans) do the same on as many
// clusters as the card holds at once.

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
// columns of the next step's input row a thread holds in registers: a block
// owns at most kClusterRegs * kClusterThreads columns
constexpr int kClusterRegs = 4;
// returned by launch_cluster when no cluster of the shape fits on the card
constexpr int kNoCluster = -1;

// Stage stamps of the recursion kernels, for cluster_probe.py only: a
// source built with OGP_STAMPS defined has thread 0 of each block write
// clock64() at each stage boundary of step t into
//     stamps[((blockIdx.y gridDim.x + blockIdx.x) k + t) kStampSlots + slot]
// when stamps is not null. In the libraries the wrappers load OGP_STAMPS is
// not defined and OGP_STAMP expands to nothing.
#ifdef OGP_STAMPS
constexpr int kStampSlots = 12;
__device__ long long* stamps;
#define OGP_STAMP(k, t, slot)                                                               \
  do {                                                                                      \
    if (threadIdx.x == 0 && ogp::stamps != nullptr)                                         \
      ogp::stamps[((static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * (k) + (t)) * \
                      ogp::kStampSlots +                                                    \
                  (slot)] = clock64();                                                      \
  } while (0)
#else
#define OGP_STAMP(k, t, slot) \
  do {                        \
  } while (0)
#endif

// A column pass over w <= 32 CT columns uses S row groups of CT warps each.
struct ColSplit {
  int CT, S;
};

__host__ __device__ inline ColSplit col_split(int W) {
  const int CT = cdiv(W, 32);
  const int S = kClusterWarps / CT;
  return ColSplit{CT, S < 1 ? 1 : S};
}

// The column tile and row group of this thread's warp in col_partials: a
// warp takes one tile of 32 columns and one row group, or, with more tiles
// than warps, tiles warp, warp + kClusterWarps, ... of the only group.
// Fixed for a kernel's life, so computed once.
struct ColTask {
  int s, ct0;
};

__device__ __forceinline__ ColTask col_task(ColSplit cs) {
  const int warp = threadIdx.x >> 5;
  if (cs.CT > kClusterWarps) return ColTask{0, warp};
  return ColTask{warp / cs.CT, warp % cs.CT};
}

// Column sums of the first t rows of X0 (and X1 when NX = 2), row stride ld,
// weighted by v[j] * scale, over the w columns of this block. Row j goes to
// row group j % S, and within a group to one of four accumulators in turn,
// added as (0 + 1) + (2 + 3); red[(x S + s) 32 CT + l] gets group s's sum
// for column l, and col_sum adds the groups in order: the same sums on
// every run. Called by every thread of the block; ends with __syncthreads()
// (unless kSync is false: the caller's own barrier then orders red).
template <int NX, bool kSync = true>
__device__ __forceinline__ void col_partials(const float* X0, const float* X1, int ld,
                                             const float* v, float scale, int t, int w,
                                             ColSplit cs, ColTask task, float* red) {
  const int lane = threadIdx.x & 31;
  const int wc = cs.CT * 32;
  const int s = task.s;
  for (int ct = task.ct0; s < cs.S && ct < cs.CT; ct += kClusterWarps) {
    const int l = ct * 32 + lane;
    if (l >= w) continue;
    float acc[NX][4];
#pragma unroll
    for (int x = 0; x < NX; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[x][c] = 0.f;
    const int step = 4 * cs.S;
    int j = s;
    for (; j + 3 * cs.S < t; j += step) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = j + c * cs.S;
        const float vj = v[jj] * scale;
        acc[0][c] = fmaf(X0[jj * ld + l], vj, acc[0][c]);
        if (NX == 2) acc[NX - 1][c] = fmaf(X1[jj * ld + l], vj, acc[NX - 1][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int jj = j + c * cs.S;
      if (jj < t) {
        const float vj = v[jj] * scale;
        acc[0][c] = fmaf(X0[jj * ld + l], vj, acc[0][c]);
        if (NX == 2) acc[NX - 1][c] = fmaf(X1[jj * ld + l], vj, acc[NX - 1][c]);
      }
    }
#pragma unroll
    for (int x = 0; x < NX; ++x)
      red[(x * cs.S + s) * wc + l] = (acc[x][0] + acc[x][1]) + (acc[x][2] + acc[x][3]);
  }
  if (kSync) __syncthreads();
}

__device__ __forceinline__ float col_sum(const float* red, int x, int l, ColSplit cs) {
  const int wc = cs.CT * 32;
  const float* r = red + x * cs.S * wc + l;
  float s = r[0];
  for (int g = 1; g < cs.S; ++g) s += r[g * wc];
  return s;
}

// Cross-block sums without cluster barriers. Each block pushes its partial
// values into a receive buffer in every block of the cluster with st.async,
// whose bytes complete a transaction on the receiver's mbarrier; a block
// waits on its own mbarrier and adds what it received in rank order, so
// every block gets the same sums. (A cluster barrier compiles to a fence at
// GPU scope, MEMBAR.ALL.GPU: one use here is about a third of a barrier
// and its DSMEM reads on an H100, cluster_probe.py.) Uses alternate
// between two buffers and two mbarriers; use n of a channel is the n-th
// exchange, the same in every block. A block reads its buffer of use n
// before it pushes use n + 1, with a __syncthreads() between, so no block
// can push use n + 2 into that buffer before it has been read.
struct Exchange {
  unsigned long long* bars;  // 2 mbarriers
  float* recv;               // 2 x C x stride: [use & 1][source rank][slot]
  int C, stride, rank;
};

// Every thread of every block calls it once, before the first use.
__device__ __forceinline__ void exchange_init(const Exchange& x) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(x.bars + b)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cg::this_cluster().sync();  // no block pushes before every block's mbarriers exist
}

// Use n receives len floats from each block: thread 0 arms the mbarrier.
__device__ __forceinline__ void exchange_expect(const Exchange& x, int n, int len) {
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(x.bars + (n & 1))),
                 "r"(x.C * len * 4)
                 : "memory");
}

// v into slot i of this block's row of use n, in blocks r0, r0 + dr, ...
// of the cluster (every block when r0 = 0, dr = 1).
__device__ __forceinline__ void exchange_push(const Exchange& x, int n, int i, float v, int r0 = 0,
                                              int dr = 1) {
  const unsigned slot = smem_u32(x.recv + ((n & 1) * x.C + x.rank) * x.stride + i);
  const unsigned bar = smem_u32(x.bars + (n & 1));
  for (int r = r0; r < x.C; r += dr) {
    unsigned rslot, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rslot) : "r"(slot), "r"(r));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(bar), "r"(r));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(rslot),
                 "r"(__float_as_uint(v)), "r"(rbar)
                 : "memory");
  }
}

// Every thread waits until use n has arrived from every block. A wait that
// outlasts ~10 s of clock traps, so a fault cannot hang the card.
__device__ __forceinline__ void exchange_wait(const Exchange& x, int n) {
  const unsigned bar = smem_u32(x.bars + (n & 1));
  const unsigned parity = (n >> 1) & 1;
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// Slot i of use n summed over the source blocks in rank order.
__device__ __forceinline__ float exchange_sum(const Exchange& x, int n, int i) {
  const float* r = x.recv + (n & 1) * x.C * x.stride + i;
  float s = r[0];
  for (int q = 1; q < x.C; ++q) s += r[q * x.stride];
  return s;
}

// ---- sums across the clusters of one output (GridExchange) ----
//
// Where one output's columns span G clusters (K1's recursion past what one
// cluster's shared memory holds, and the recursions spread over the card,
// K1's and K3's), a sum is taken in two levels: within each cluster through
// Exchange, then across the G clusters through device memory. Block rank 0
// of cluster g writes its cluster's sum of slot i of use n into word
// (b G + g) stride + i of the output's slots, b = n & 1, the float and the
// use's tag n + 1 in one 64-bit store (a 64-bit word is read all or
// nothing, so no fence stands between a value and its tag); a thread that
// needs slot i reads its G words, again until each carries use n's tag, and
// adds the G cluster sums in cluster order, so every block gets the same
// sums, and a second call the same bits. No atomics. Uses alternate between
// two buffers, as Exchange's do: a cluster writes use n + 2 only after its
// writer has read every cluster's use n + 1, which each cluster wrote only
// after all its blocks had read use n, so no write overtakes a read, and a
// reader that waits for use n's exact tag never takes an older or a newer
// use. The slots of a launch are zeroed before it (torch.zeros in the
// wrappers: tag 0 is no use's), 2 G stride words an output. Every cluster of
// the launch must be resident at once, or a cluster waits on one that is
// never scheduled: the launch checks the clusters against
// cudaOccupancyMaxActiveClusters (launch_cluster_grid's `need`), and a wait
// that outlasts ~10 s of clock traps rather than hangs the card.
constexpr int kMaxGridClusters = 8;     // K1's grid recursion (all of a block's slices in shared memory)
constexpr int kMaxSpreadClusters = 16;  // the recursions spread over the card

struct GridExchange {
  unsigned long long* slots;  // this output's words, (2, G, stride)
  int G, stride, g;           // clusters per output, words per use of a cluster, this block's cluster
  bool writer;                // block rank 0 of its cluster
};

// v, this cluster's sum of slot i of use n (the same in each of its
// blocks), summed over the G <= kMaxG clusters in cluster order.
template <int kMaxG>
__device__ __forceinline__ float grid_sum(const GridExchange& gx, int n, int i, float v) {
  const unsigned long long* row = gx.slots + static_cast<long long>(n & 1) * gx.G * gx.stride + i;
  const unsigned long long tag = static_cast<unsigned long long>(n + 1) << 32;
  if (gx.writer) {
    const unsigned long long word = tag | __float_as_uint(v);
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(row + gx.g * gx.stride), "l"(word) : "memory");
  }
  unsigned long long w[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) w[g] = 0;
  unsigned ready = 0;
  const unsigned all = (1u << gx.G) - 1;
  const long long start = clock64();
  for (;;) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < gx.G && !((ready >> g) & 1u))
        asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w[g]) : "l"(row + g * gx.stride) : "memory");
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < gx.G && (w[g] & 0xffffffff00000000ULL) == tag) ready |= 1u << g;
    if (ready == all) break;
    if (clock64() - start > (1LL << 34)) __trap();
  }
  float s = __uint_as_float(static_cast<unsigned>(w[0]));
#pragma unroll
  for (int g = 1; g < kMaxG; ++g)
    if (g < gx.G) s += __uint_as_float(static_cast<unsigned>(w[g]));
  return s;
}

// The launch configuration of kernel on `grid` (grid.x a multiple of C)
// of `threads`-thread blocks in clusters of C along x, with smem bytes of
// dynamic shared memory, into cfg (whose attrs point at attr[0]), after
// setting the kernel's attributes: its dynamic shared memory, and above 8
// blocks, the portable limit, cudaFuncAttributeNonPortableClusterSizeAllowed.
// A refused attribute is returned here and cleared, so that the next
// launch's cudaGetLastError() does not report it again.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int C, dim3 grid, int threads, long long smem, cudaStream_t s,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess && C > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of C blocks of the shape the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t of a refused
// attribute or query.
template <typename Kernel>
int cluster_capacity(Kernel kernel, int C, int threads, long long smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kernel, C, dim3(C, 1, 1), threads, smem, 0, cfg, attr);
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

// Launches kernel(args...) on a grid of `threads`-thread blocks in
// clusters of C along x (grid.x a multiple of C), with smem bytes of
// dynamic shared memory. Returns kNoCluster when the card cannot hold
// `need` such clusters at once (one, unless the clusters of the launch
// wait on each other: GridExchange), else the launch's cudaError_t.
// Nothing is retried or rerouted here.
template <typename Kernel, typename... Args>
int launch_cluster_grid(Kernel kernel, int C, dim3 grid, int threads, long long smem,
                        cudaStream_t s, int need, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kernel, C, grid, threads, smem, s, cfg, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < need) return kNoCluster;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The recursions' launch: a (C, Bd) grid of kClusterThreads-thread blocks.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int C, int Bd, long long smem, cudaStream_t s, Args... args) {
  return launch_cluster_grid(kernel, C, dim3(C, Bd, 1), kClusterThreads, smem, s, 1, args...);
}

}  // namespace ogp
