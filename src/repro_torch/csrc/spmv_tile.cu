// Bitmask-tiled SpMV: the tile walk over the occupied tiles of each block
// row, on the flat device operands (tile_contrib) and on one TileMatrix
// (tile_walk_spmv).
//
// Replaces: src/repro/kernels/spmv_tile.py tile_contrib
// (_tile_contrib_kernel, pallas_call at :101), plus the jnp x-lane gather
// before it and the block-row scatter-add after it
// (src/repro/kernels/ops.py:490-493); and tile_walk_spmv
// (_tile_spmv_kernel, pallas_call at :65), the walk of the host op
// tile_spmv (ops.py:463) and of the deprecated bell_* shims (:132, :151).
//
// tile_contrib:   y[s, b, mb*BM + i] = sum over block row mb's tiles t
//                   (in stored order) of sum_j data[s, t, i, j] * x[s, b, xcol[s, t, j]]
// tile_walk_spmv: y[b, mb*bm + i] = sum over t in tile_ptr[mb] .. tile_ptr[mb+1]
//                   of sum_j data[t, i, j] * x[b, tile_cols[t]*BN + j]   (x = 0 past n)
//
// What bounds them on the H100: bytes.  A tile moves BM*BN*4 bytes of data
// (plus BN*4 bytes of lane positions for tile_contrib, 4 bytes of block
// column for the walk) for 2*BM*BN flops, 0.5 flop per byte (each x lane
// is reused by the tile's BM rows).  The TPU kernels ran one (bm, bn) @
// (bn,) MXU/VPU product per grid step: tile_contrib on x lanes gathered
// beforehand by jnp, with a jnp scatter of the (T, bm) results after it;
// the walk on a (Mb, K) grid fed by scalar-prefetched (counts, tid, bc)
// tables padded to the widest block row, with the slots past counts[mb]
// re-reading a tile and masked to zero.
//
// Design: one warp per (shard, block row), or for the walk per (block
// row, group of 8 rows) so tall tiles ((16, 128), (128, 128)) keep 8
// accumulators a lane.  The warp walks the block row's run of tiles
// straight from the pointer grid (tile_ptr; padding tiles of the flat
// operands carry block row Rb, lie past every run and are never visited),
// so the TPU's padded walk tables and masked slots have no counterpart.
// tile_contrib gathers its BN x lanes through xcol itself; the walk reads
// the contiguous BN-lane slice of x at its block column (coalesced) and
// masks lanes >= n, so x needs no padding and nothing past it is read.
// tile_contrib adds each tile's BM row products (a fixed butterfly each)
// in tile order; the walk keeps per-lane partials in registers across the
// tiles, in tile order, and reduces them once with a fixed butterfly.  A
// block row without tiles writes zeros.  No atomics, no scatter:
// deterministic.
#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

template <int BM, int BN>
__global__ void tile_spmv_kernel(const float* __restrict__ data,
                                 const int* __restrict__ xcol,
                                 const int* __restrict__ tile_ptr,
                                 const float* __restrict__ x,
                                 long long x_stride,
                                 const int* __restrict__ sids, int n_sids,
                                 int Tp, int Rb, int Lx, int B,
                                 float* __restrict__ y) {
  static_assert(BN % WARP == 0, "tile width must be a multiple of 32");
  constexpr int PER_LANE = BN / WARP;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)n_sids * Rb) return;
  const int k = (int)(item / Rb), mb = (int)(item % Rb), b = blockIdx.y;
  const int sid = sids[k];
  const float* xv = shard_x(x, x_stride, sid, b, Lx);
  const int* ptr = tile_ptr + (long long)sid * (Rb + 1);
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;
  for (int t = ptr[mb]; t < ptr[mb + 1]; ++t) {
    const long long tile = (long long)sid * Tp + t;
    const float* d = data + tile * BM * BN;
    const int* xc = xcol + tile * BN;
    float xl[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) xl[j] = xv[xc[lane + WARP * j]];
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        s = fmaf(d[i * BN + lane + WARP * j], xl[j], s);
      acc[i] += warp_sum(s);
    }
  }
  if (lane == 0) {
    float* out = y + ((long long)sid * B + b) * ((long long)Rb * BM) +
                 (long long)mb * BM;
#pragma unroll
    for (int i = 0; i < BM; ++i) out[i] = acc[i];
  }
}

template <int BN>
__global__ void tile_walk_kernel(const float* __restrict__ data,
                                 const int* __restrict__ tile_cols,
                                 const int* __restrict__ tile_ptr,
                                 const float* __restrict__ x, int Mb, int bm,
                                 int n, float* __restrict__ y) {
  static_assert(BN % WARP == 0, "tile width must be a multiple of 32");
  constexpr int RG = 8, PER_LANE = BN / WARP;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int groups = bm / RG;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)Mb * groups) return;
  const int mb = (int)(item / groups), g = (int)(item % groups);
  const int b = blockIdx.y;
  const float* xv = x + (long long)b * n;
  float part[RG][PER_LANE];
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) part[i][j] = 0.f;
  for (int t = tile_ptr[mb]; t < tile_ptr[mb + 1]; ++t) {
    const float* d = data + ((long long)t * bm + g * RG) * BN;
    const long long c0 = (long long)tile_cols[t] * BN + lane;
    float xl[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const long long c = c0 + WARP * j;
      xl[j] = c < n ? xv[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        part[i][j] = fmaf(d[i * BN + lane + WARP * j], xl[j], part[i][j]);
  }
  float acc[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) s += part[i][j];
    acc[i] = warp_sum(s);
  }
  if (lane == 0) {
    float* out = y + (long long)b * Mb * bm + (long long)mb * bm + g * RG;
#pragma unroll
    for (int i = 0; i < RG; ++i) out[i] = acc[i];
  }
}

}  // namespace

// data (T, bm, BN), tile_cols (T,), tile_ptr (Mb+1,), x (B, n), y (B, Mb*bm);
// bm a multiple of 8, BN = 128.
RT_API int rt_tile_walk_spmv(const float* data, const int* tile_cols,
                             const int* tile_ptr, const float* x, int Mb,
                             int bm, int bn, int n, int B, float* y,
                             void* stream) {
  if (bn != 128 || bm <= 0 || bm % 8) return (int)cudaErrorInvalidValue;
  const long long items = (long long)Mb * (bm / 8);
  if (items == 0 || B == 0) return 0;
  dim3 grid((unsigned)((items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK),
            (unsigned)B);
  tile_walk_kernel<128><<<grid, WARPS_PER_BLOCK * WARP, 0,
                          (cudaStream_t)stream>>>(data, tile_cols, tile_ptr,
                                                  x, Mb, bm, n, y);
  return (int)cudaGetLastError();
}

RT_API int rt_tile_spmv(const float* data, const int* xcol,
                        const int* tile_ptr, const float* x,
                        long long x_stride, const int* sids, int n_sids,
                        int Tp, int Rb, int BM, int BN, int Lx, int B,
                        float* y, void* stream) {
  if (BM != 8 || BN != 128) return (int)cudaErrorInvalidValue;
  const long long items = (long long)n_sids * Rb;
  if (items == 0 || B == 0) return 0;
  dim3 grid((unsigned)((items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK),
            (unsigned)B);
  tile_spmv_kernel<8, 128><<<grid, WARPS_PER_BLOCK * WARP, 0,
                             (cudaStream_t)stream>>>(
      data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, Lx, B, y);
  return (int)cudaGetLastError();
}
