// Shared definitions of the port's SpMV kernels (plain C interface, loaded
// from Python with ctypes by repro_torch/kernels/_lib.py).
//
// Operand conventions, shared by every kernel:
//   * operands are S-stacked exactly as the executor builds them (one slab
//     per shard, padded to the largest shard); a launch covers only the
//     shards listed in `sids` (n_sids entries, int32 on the device);
//   * everything batched is batch-major: the x buffer is (Sx, B, Lx), the
//     output is (S, B, R).  Sx is S (one buffer per shard, x_stride =
//     B * Lx) or 1 (one vector every shard reads, x_stride = 0);
//   * column b of a batched call runs exactly the per-vector arithmetic,
//     and no kernel uses atomics, so every result is bitwise-deterministic
//     and batched columns equal per-vector calls.  split_psum and
//     split_combine take one column per grid.y; ell_spmv, tile_contrib,
//     tile_walk_spmv, seg_psum and seg_fixup keep RHS_CHUNK columns' sums
//     per thread (grid.y = chunk), so one load of a matrix entry or piece
//     record feeds every column of a chunk.
// Every launcher returns cudaGetLastError() so a refused launch is seen.
#pragma once
#include <cuda_runtime.h>

#define RT_API extern "C" __attribute__((visibility("default")))

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP = 32;
constexpr int RHS_CHUNK = 8;      // columns of x a thread keeps sums for

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the same, order-fixed sum.
  for (int off = WARP / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// The same butterfly over an aligned group of G lanes (G a power of two
// <= 32); `mask` names the group's lanes.
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__device__ __forceinline__ const float* shard_x(const float* x,
                                                long long x_stride, int sid,
                                                int b, int Lx) {
  return x + (long long)sid * x_stride + (long long)b * Lx;
}

// Inclusive prefix sum of one value per thread over a block of L threads
// (L a multiple of 32, at most 1024): a shuffle scan inside each warp,
// then one pass of warp 0 over the warp totals in `warp_tot` (shared,
// WARP floats).  The order is fixed, so the result is deterministic.
// Every thread of the block must call it.
__device__ __forceinline__ float block_inclusive_scan(float v,
                                                      float* warp_tot) {
  const int l = threadIdx.x, lane = l % WARP, warp = l / WARP;
  for (int d = 1; d < WARP; d <<= 1) {
    const float t = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v += t;
  }
  if (lane == WARP - 1) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / WARP;
    float t = lane < nw ? warp_tot[lane] : 0.f;
    for (int d = 1; d < WARP; d <<= 1) {
      const float u = __shfl_up_sync(FULL_MASK, t, d);
      if (lane >= d) t += u;
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  return v;
}
