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
//     and batched columns equal per-vector calls.  split_combine takes one
//     column per grid.y; ell_spmv, tile_contrib, tile_walk_spmv, seg_psum
//     (and split_psum, which is seg_psum's scan), seg_piece_sums and
//     seg_fixup keep RHS_CHUNK columns' sums per thread (grid.y = chunk),
//     so one load of a matrix entry or piece record feeds every column of
//     a chunk.
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

// seg_psum's per-chunk scan (spmv_seg.cu): C chunks of L elements (L % 4
// == 0) of each of the n_sids shards listed in `sids` (null: the k-th
// launched shard is shard k), x (Sx, B, Lx) at x_stride, psum
// (n_sids, B, C, L).  split_psum launches it on its flattened slab.
// Returns cudaGetLastError().
int launch_seg_psum(const float* vals, const int* cols, const float* x,
                    long long x_stride, const int* sids, int n_sids, int C,
                    int L, int Lx, int B, float* psum, cudaStream_t stream);
