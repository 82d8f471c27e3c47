// Shared definitions of the port's SpMV kernels (plain C interface, loaded
// from Python with ctypes by repro_torch/kernels/_lib.py).
//
// Operand conventions, shared by every kernel:
//   * operands are S-stacked exactly as the executor builds them (one slab
//     per shard, padded to the largest shard); a launch covers only the
//     shards listed in `sids` (n_sids entries, int32 on the device);
//   * x is batch-minor: the buffer is (Sx, Lx, B), element (col, b) of a
//     shard at x[col * B + b], so an element's B columns are one row of
//     B * 4 bytes (B = 8: one 32-byte sector).  Sx is S (one buffer per
//     shard, x_stride = Lx * B) or 1 (one vector every shard reads,
//     x_stride = 0).  The output stays batch-major, (S, B, R);
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

// Column b0 of shard sid's x buffer: row col of it starts at
// x_row<NB>(that, col, B).
__device__ __forceinline__ const float* shard_x(const float* x,
                                                long long x_stride, int sid,
                                                int b0) {
  return x + (long long)sid * x_stride + b0;
}

// The row of element col, from column b0 (`xv`, as shard_x gives it).  A
// one-column kernel (NB = 1) runs only at B = 1, where the row is the
// element itself.
template <int NB>
__device__ __forceinline__ const float* x_row(const float* xv, long long col,
                                              int B) {
  return NB == 1 ? xv + col : xv + col * B;
}

// Whether x's rows take 16-byte loads: B % 4 == 0 and x 16-byte aligned,
// so that every shard's buffer, every row and every chunk's column b0
// (a multiple of RHS_CHUNK) is.
__device__ __forceinline__ bool x_rows_vec(const float* x, int B) {
  return B % 4 == 0 && (reinterpret_cast<unsigned long long>(x) & 15) == 0;
}

// Columns 0 .. nb-1 of one row of x (`xr`, from column b0) into r: 16-byte
// loads where `vec` (x_rows_vec; nb is then a multiple of 4, and r is 0
// past it), else one 4-byte load a column below nb (r past it is left as
// it is).  A one-column kernel loads xr[0].
template <int NB>
__device__ __forceinline__ void load_x_row(const float* xr, int nb, bool vec,
                                           float (&r)[NB]) {
  if constexpr (NB % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * q < nb) t = *reinterpret_cast<const float4*>(xr + 4 * q);
        r[4 * q] = t.x, r[4 * q + 1] = t.y, r[4 * q + 2] = t.z,
              r[4 * q + 3] = t.w;
      }
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < nb) r[b] = xr[b];
}

// seg_psum's per-chunk scan (spmv_seg.cu): C chunks of L elements (L % 4
// == 0) of each of the n_sids shards listed in `sids` (null: the k-th
// launched shard is shard k), x (Sx, Lx, B) at x_stride, psum
// (n_sids, B, C, L).  split_psum launches it on its flattened slab.
// Returns cudaGetLastError().
int launch_seg_psum(const float* vals, const int* cols, const float* x,
                    long long x_stride, const int* sids, int n_sids, int C,
                    int L, int B, float* psum, cudaStream_t stream);
