// Helpers shared by the port's CUDA kernels: warp and block sums, and one
// shared-memory-tiled f32 GEMM tile routine.
//
// All math is f32 with FMA; nothing here uses tensor cores (TF32 is off by
// the port's precision policy) and nothing uses wgmma or TMA yet: these are
// the first, simple versions of the kernels.
#pragma once

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

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace ogp
