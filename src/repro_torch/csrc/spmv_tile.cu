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
// What bounds them on the H100: bytes.  tile_contrib moves a tile's
// BM*BN*4 bytes of data plus BN*4 bytes of lane positions for 2*BM*BN
// flops.  The TPU kernels ran one (bm, bn) @ (bn,) MXU/VPU product per
// grid step, since a DMA block is the TPU's unit: tile_contrib on x lanes
// gathered beforehand by jnp, with a jnp scatter of the (T, bm) results
// after it; the walk on a (Mb, K) grid fed by scalar-prefetched (counts,
// tid, bc) tables padded to the widest block row, with the slots past
// counts[mb] re-reading a tile and masked to zero.  Hopper fetches device
// memory in 32-byte sectors, and one byte of the TileMatrix's packed
// occupancy mask covers exactly one sector of data (8 floats of a tile
// row), so the walk reads the mask and only the occupied sectors: on
// blocked_band (fill 0.44%) 122 MB of mask and 48 MB of sectors where
// whole tiles are 3.9 GB.
//
// Design: both walk a block row's run of tiles straight from the pointer
// grid (tile_ptr; padding tiles of the flat operands carry block row Rb,
// lie past every run and are never visited), so the TPU's padded walk
// tables and masked slots have no counterpart.  A block row without tiles
// writes zeros.  No atomics, no scatter: deterministic.
//
// tile_contrib: one warp per (shard, block row); lanes stride a tile's BN
// lanes, gather their x through xcol, and each tile's BM row products are
// added in tile order (a fixed butterfly each).
//
// tile_walk_spmv: one warp per (block row, group of 8 rows), so tall tiles
// ((16, 128), (128, 128)) go as 8-row groups.  Lane (u, r) owns row r of
// the group in the tiles t_lo + u, t_lo + u + 4, ...: a warp step covers 4
// tiles, and each lane reads its row's 16 mask bytes as one 16-byte load
// (the warp's 512 bytes coalesced).  It then reads the row's occupied
// cells only, in ascending column (a quarter row whose 32 cells are all
// occupied as eight 16-byte loads), x at the block column's lanes (never
// past n), and keeps one sum a column of x for RHS_CHUNK columns, so one
// load of a cell feeds every column.  Most tile rows hold at most one
// cell, so a walk of one step at a time waits on two dependent loads
// (mask, then cell) per step; the kernel loads the masks of STEPS steps,
// then the first cell of each (data and x), before it adds any, so those
// waits overlap.  More steps hold more registers, and with them fewer
// resident warps (tools/tile_walk_steps.py times the choices).  The 4 tile slots of a row are added with a
// fixed butterfly at the end.  Each column's additions run in the order of
// the single-vector call, so batched columns equal it bitwise.  The cells
// added are exactly the stored entries (CSR semantics: a non-finite x in
// an unoccupied cell is never read; the TPU kernel multiplied it by 0).
// A null mask (the Block-ELL shims' slab) takes tile_walk_dense_kernel:
// every cell is read, with the lanes across the row so the loads coalesce.
#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int STEPS = 2;           // tile_walk_spmv: warp steps loaded at once

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

// Bit j of the result is the occupancy of column 32q + j of a tile row,
// from its mask word q (bytes 4q .. 4q+3 of the row's bn/8 mask bytes,
// little-endian); np.packbits puts column 8k + i at bit 7 - i of byte k,
// so the bits are reversed within each byte.
__device__ __forceinline__ unsigned column_bits(unsigned word) {
  return __brev(__byte_perm(word, 0, 0x0123));
}

// The lowest occupied column of a tile row whose quarter is not full, or
// -1 (an empty row, or a full lowest quarter: the 16-byte path reads it).
__device__ __forceinline__ int first_lone_cell(const uint4& m) {
  const unsigned words[4] = {m.x, m.y, m.z, m.w};
  int j = -1;
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    const unsigned bits = column_bits(words[q]);
    if (bits) j = bits == ~0u ? -1 : 32 * q + __ffs(bits) - 1;
  }
  return j;
}

template <int NB>
__global__ void tile_walk_kernel(const float* __restrict__ data,
                                 const unsigned char* __restrict__ mask,
                                 const int* __restrict__ tile_cols,
                                 const int* __restrict__ tile_ptr,
                                 const float* __restrict__ x, int Mb, int bm,
                                 int n, int B, float* __restrict__ y) {
  constexpr int BN = 128, RG = 8, TPS = WARP / RG;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int groups = bm / RG;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)Mb * groups) return;
  const int mb = (int)(item / groups), g = (int)(item % groups);
  const int r = lane % RG, u = lane / RG;
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const float* xv = x + (long long)b0 * n;
  const int t_hi = tile_ptr[mb + 1];
  // lane (u, r): row g*RG + r of the tiles t_lo + u, t_lo + u + TPS, ...
  auto row_of = [&](int t) { return (long long)t * bm + g * RG + r; };
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int t0 = tile_ptr[mb]; t0 < t_hi; t0 += TPS * STEPS) {
    // STEPS warp steps at once: their masks and block columns, then the
    // first occupied cell of each (most rows hold at most one), all
    // loaded before any is used
    uint4 m[STEPS];
    long long xc[STEPS];
    int jf[STEPS];
    float df[STEPS], xf[STEPS][NB];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int t = t0 + u + TPS * k;
      m[k] = t < t_hi
                 ? __ldg(reinterpret_cast<const uint4*>(mask) + row_of(t))
                 : make_uint4(0u, 0u, 0u, 0u);
      xc[k] = t < t_hi ? (long long)tile_cols[t] * BN : 0;
    }
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int f = first_lone_cell(m[k]);
      jf[k] = xc[k] + f < n ? f : -1;       // a mask marks no cell past x
      const int j = max(jf[k], 0);
      df[k] = jf[k] >= 0 ? data[row_of(t0 + u + TPS * k) * BN + j] : 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        xf[k][b] = jf[k] >= 0 && b < nb ? xv[(long long)b * n + xc[k] + j]
                                        : 0.f;
    }
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const float* drow = data + row_of(t0 + u + TPS * k) * BN;
      const unsigned words[4] = {m[k].x, m[k].y, m[k].z, m[k].w};
      if (jf[k] >= 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b < nb) acc[b] = fmaf(df[k], xf[k][b], acc[b]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned bits = column_bits(words[q]);
        if (jf[k] >> 5 == q) bits &= bits - 1;    // the cell done above
        if (bits == ~0u && xc[k] + 32 * (q + 1) <= n) {
          // a full quarter row: eight 16-byte loads, the same in-order FMAs
          float v[32];
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const float4 d4 =
                __ldg(reinterpret_cast<const float4*>(drow + 32 * q) + s);
            v[4 * s] = d4.x, v[4 * s + 1] = d4.y, v[4 * s + 2] = d4.z,
                    v[4 * s + 3] = d4.w;
          }
#pragma unroll
          for (int j = 0; j < 32; ++j)
#pragma unroll
            for (int b = 0; b < NB; ++b)
              if (b < nb)
                acc[b] = fmaf(v[j], xv[(long long)b * n + xc[k] + 32 * q + j],
                              acc[b]);
          continue;
        }
        while (bits) {              // the other occupied cells, ascending
          const int j = 32 * q + __ffs(bits) - 1;
          bits &= bits - 1;
          if (xc[k] + j >= n) break;   // a mask marks no cell past x
          const float d = drow[j];
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (b < nb)
              acc[b] = fmaf(d, xv[(long long)b * n + xc[k] + j], acc[b]);
        }
      }
    }
  }
  // the TPS tile slots of each row, in a fixed butterfly
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    acc[b] += __shfl_xor_sync(FULL_MASK, acc[b], RG);
    acc[b] += __shfl_xor_sync(FULL_MASK, acc[b], 2 * RG);
  }
  if (u == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb)
        y[(long long)(b0 + b) * Mb * bm + (long long)mb * bm + g * RG + r] =
            acc[b];
  }
}

// The null-mask walk (the Block-ELL shims' zero-padded slab): every cell
// is read, so the lanes span a tile row instead (lane l: cells 4l .. 4l+3
// of each of the group's 8 rows, one 16-byte load a row, the warp's loads
// of a row coalesced), keep per-row partials across the tiles in tile
// order, and reduce each row once with a fixed butterfly.
template <int NB>
__global__ void tile_walk_dense_kernel(const float* __restrict__ data,
                                       const int* __restrict__ tile_cols,
                                       const int* __restrict__ tile_ptr,
                                       const float* __restrict__ x, int Mb,
                                       int bm, int n, int B,
                                       float* __restrict__ y) {
  constexpr int BN = 128, RG = 8;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int groups = bm / RG;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)Mb * groups) return;
  const int mb = (int)(item / groups), g = (int)(item % groups);
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const float* xv = x + (long long)b0 * n;
  float part[RG][NB];
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int b = 0; b < NB; ++b) part[i][b] = 0.f;
  for (int t = tile_ptr[mb]; t < tile_ptr[mb + 1]; ++t) {
    const float4* d = reinterpret_cast<const float4*>(
                          data + ((long long)t * bm + g * RG) * BN) + lane;
    const long long c = (long long)tile_cols[t] * BN + 4 * lane;
    float4 dv[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) dv[i] = __ldg(d + i * (BN / 4));
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb) break;
      const float* xb = xv + (long long)b * n;
      const float x0 = c < n ? xb[c] : 0.f, x1 = c + 1 < n ? xb[c + 1] : 0.f,
                  x2 = c + 2 < n ? xb[c + 2] : 0.f,
                  x3 = c + 3 < n ? xb[c + 3] : 0.f;
#pragma unroll
      for (int i = 0; i < RG; ++i)
        part[i][b] = fmaf(dv[i].w, x3, fmaf(dv[i].z, x2, fmaf(dv[i].y, x1,
                          fmaf(dv[i].x, x0, part[i][b]))));
    }
  }
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int b = 0; b < NB; ++b) part[i][b] = warp_sum(part[i][b]);
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb) break;
      float* out = y + (long long)(b0 + b) * Mb * bm + (long long)mb * bm +
                   g * RG;
#pragma unroll
      for (int i = 0; i < RG; ++i) out[i] = part[i][b];
    }
  }
}

}  // namespace

// data (T, bm, BN), mask (T, bm, BN/8) packed occupancy or null (every
// cell occupied), tile_cols (T,), tile_ptr (Mb+1,), x (B, n),
// y (B, Mb*bm); bm a multiple of 8, BN = 128.
RT_API int rt_tile_walk_spmv(const float* data, const unsigned char* mask,
                             const int* tile_cols, const int* tile_ptr,
                             const float* x, int Mb, int bm, int bn, int n,
                             int B, float* y, void* stream) {
  if (bn != 128 || bm <= 0 || bm % 8) return (int)cudaErrorInvalidValue;
  const long long items = (long long)Mb * (bm / 8);
  if (items == 0 || B == 0) return 0;
  const unsigned blocks =
      (unsigned)((items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks, (B + RHS_CHUNK - 1) / RHS_CHUNK);
  const int threads = WARPS_PER_BLOCK * WARP;
  if (mask == nullptr && B == 1)
    tile_walk_dense_kernel<1><<<blocks, threads, 0, s>>>(
        data, tile_cols, tile_ptr, x, Mb, bm, n, B, y);
  else if (mask == nullptr)
    tile_walk_dense_kernel<RHS_CHUNK><<<grid, threads, 0, s>>>(
        data, tile_cols, tile_ptr, x, Mb, bm, n, B, y);
  else if (B == 1)
    tile_walk_kernel<1><<<blocks, threads, 0, s>>>(
        data, mask, tile_cols, tile_ptr, x, Mb, bm, n, B, y);
  else
    tile_walk_kernel<RHS_CHUNK><<<grid, threads, 0, s>>>(
        data, mask, tile_cols, tile_ptr, x, Mb, bm, n, B, y);
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
