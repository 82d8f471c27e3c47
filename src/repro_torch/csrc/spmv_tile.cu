// Bitmask-tiled SpMV over the flat device operands.
//
// Replaces: src/repro/kernels/spmv_tile.py tile_contrib
// (_tile_contrib_kernel, pallas_call at :101), plus the jnp x-lane gather
// before it and the block-row scatter-add after it
// (src/repro/kernels/ops.py:490-493).
//
// y[s, b, mb*BM + i] = sum over block row mb's tiles t (in stored order) of
//                      sum_j data[s, t, i, j] * x[s, b, xcol[s, t, j]]
//
// What bounds it on the H100: bytes.  A tile moves BM*BN*4 bytes of data
// and BN*4 bytes of lane positions for 2*BM*BN flops, 0.5 flop per byte
// (each gathered x lane is reused by the tile's BM rows).  The TPU kernel
// ran one (8, 128) @ (128,) MXU/VPU product per grid step on x lanes
// gathered beforehand by jnp, and scattered the (T, 8) results with jnp.
//
// Design: one warp per (shard, block row).  The warp walks the block
// row's run of tiles (tiles are sorted by block row; the run comes from
// the host table tile_ptr, (S, Rb+1), built with searchsorted over
// tile_brow), gathers its BN x lanes through xcol itself (BN/32 per lane),
// forms the BM row products with a fixed butterfly reduction each, and
// adds them to BM register accumulators in tile order.  Padding tiles
// carry tile_brow = Rb, lie past every run and are never visited.  No
// atomics, no scatter: deterministic.
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

}  // namespace

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
