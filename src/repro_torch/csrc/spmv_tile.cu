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
//                   (in stored order) of sum_j data[s, t, i, j] * x[s, xcol[s, t, j], b]
// tile_walk_spmv: y[b, mb*bm + i] = sum over t in tile_ptr[mb] .. tile_ptr[mb+1]
//                   of sum_j data[t, i, j] * x[tile_cols[t]*BN + j, b]   (x = 0 past n)
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
// tile_contrib: the executor's tile shards fill few block rows of an
// output padded to the largest shard's rows (blocked_band: below 208 of
// 7,463), so warps go only where tiles are: one warp per (shard, block
// row below rb_used), and the rows from rb_used*BM on are zeroed by the
// launch's fill blocks with 16-byte stores (rt_tile_spmv sizes both).
// Lanes span a tile row: lane l reads cells 4l .. 4l+3 of the 8 rows
// (eight 16-byte loads) and its 4 lane positions (one 16-byte load), keeps
// per-row partials across the block row's tiles in tile order, and the 8
// rows are summed once, at the end, with a fixed butterfly (store_rows).
// The data and positions of the next PREFETCH tiles, and the next tile's
// x, are loaded before a tile's FMAs, so a block row's dependent loads
// overlap.  One load feeds RHS_CHUNK columns, whose x values, x being
// batch-minor, lie in one row (at B = 8 one sector a cell, where the
// batch-major x took one a column): the lanes-across walks load a cell's
// row in 16-byte loads where B % 4 == 0 (load_x_row), the masked walks,
// whose lanes read lone cells, 4 bytes at a time (16-byte loads, which
// their unrolled walks hoisted, took the masked walk from 80 to 186
// registers at 8 columns and made it 1.9x slower: api/tile, H100).  A
// lane's 4 cells of 8 columns are then its own 128 bytes, so a warp's
// load touches 32 lines where the batch-major one touched 4: at B = 8 the
// general lanes-across walks run 13-17% slower than they did batch-major
// (api/bell16x16, api/tile_flat16x128, H100), and staging the rows
// through shared memory, a warp's loads coalesced, was slower still.
// The null-mask walk (tile_walk_dense_kernel) is the same walk, x read at
// the tile's block column instead of through xcol.
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
// resident warps (tools/kernel_variants.py times the choices).  The 4 tile
// slots of a row are added with a fixed butterfly at the end.  Each
// column's additions run in the order of the single-vector call, so
// batched columns equal it bitwise.  The cells
// added are exactly the stored entries (CSR semantics: a non-finite x in
// an unoccupied cell is never read; the TPU kernel multiplied it by 0).
// A null mask (the Block-ELL shims' slab) takes tile_walk_dense_kernel:
// every cell is read, with the lanes across the row so the loads coalesce.
// Both tile_contrib and the dense walk add a lane's 4 cells of a row in
// column order into its running partial, then sum the 32 lanes with the
// butterfly of warp_sum, so each column equals the single-vector call.
//
// These fast walks take (8k, 128) tiles (tile_contrib: (8, 128)).  Every
// other shape the reference takes goes to the general walks (below), which
// read what the fast walks read: the masked one the fast walk's layout with
// RG-row groups and a row's bn / 8 mask bytes in aligned loads, the others
// lanes across (tile, row, cell) in 16-byte loads where bn % 4 == 0, with
// tile_contrib's zero fill in 4-byte stores (bm * rows need not be a
// multiple of 4).
#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int STEPS = 2;           // tile_walk_spmv: warp steps loaded at once
// Lanes-across-row walks: tiles loaded ahead of the adds.  2 ties 1 on
// blocked_band's tile_contrib (tools/kernel_variants.py contrib) and needs
// 175 registers to 109, and spills with RHS_CHUNK columns (ptxas -v); 4
// spills with one.
constexpr int PREFETCH = 1;
// Zero stores a thread of a tile_contrib fill block makes: 16 bytes each
// at (8, 128) tiles, 4 at any other shape.
constexpr int FILL_STORES = 4;
// The general walks (any other tile shape; tools/kernel_variants.py
// general times the choices).  The masked walk: items whose masks and
// first cells it loads at once (2 holds 72 registers to 40 at B = 1, and
// so fewer warps, and is slower), and the most rows a warp owns.  The
// null-mask and tile_contrib walks: items loaded ahead of the adds, and
// the most rows a warp holds (a power of two).
constexpr int GENERAL_STEPS = 1;
constexpr int GENERAL_GROUP = 4;
constexpr int GENERAL_PREFETCH = 2;
constexpr int GENERAL_ROWS = 4;

// The lanes-across-row walk of tile_contrib and the null-mask walk: a warp
// owns 8 rows of a run of (8k, 128) tiles, lane l cells 4l .. 4l+3 of each
// row (one 16-byte load a row, the warp's loads of a row coalesced) and
// the 4 x values they meet, a column each.  `part` holds a lane's running
// sums, a row and a column each.
template <int NB>
__device__ __forceinline__ void add_tile(float (&part)[8][NB],
                                         const float4 (&d)[8],
                                         const float (&xv)[4][NB], int nb) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b >= nb) break;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      part[i][b] = fmaf(d[i].w, xv[3][b], fmaf(d[i].z, xv[2][b],
                        fmaf(d[i].y, xv[1][b], fmaf(d[i].x, xv[0][b],
                                                    part[i][b]))));
  }
}

constexpr int ROW4 = 128 / 4;      // 16-byte words of a tile row

// Column b0 of tile_walk_spmv's x (n, B).  A one-column walk (b0 = 0)
// keeps the batch-major address arithmetic it was compiled with before, so
// its code is unchanged.
template <int NB>
__device__ __forceinline__ const float* walk_x(const float* x, int b0,
                                               int n) {
  return NB == 1 ? x + (long long)b0 * n : x + b0;
}

// tile_contrib's (8, 128) tiles: x through the lane positions xcol.
template <int NB>
struct FlatTiles {
  const float4* data;      // tile 0 of the shard, at the lane's cells
  const int4* xcol;        // tile 0's lane positions, at the lane's 4
  const float* x;          // column b0 of the shard's x buffer
  int B, nb;
  bool vec;                // x's rows take 16-byte loads
  __device__ __forceinline__ void load(int t, float4 (&d)[8],
                                       int4& c) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      d[i] = __ldg(data + ((long long)t * 8 + i) * ROW4);
    c = __ldg(xcol + (long long)t * ROW4);
  }
  __device__ __forceinline__ void gather(const int4& c,
                                         float (&xv)[4][NB]) const {
    if constexpr (NB == 1) {
      if (nb > 0) xv[0][0] = x[c.x], xv[1][0] = x[c.y], xv[2][0] = x[c.z],
                  xv[3][0] = x[c.w];
    } else {
      load_x_row<NB>(x_row<NB>(x, c.x, B), nb, vec, xv[0]);
      load_x_row<NB>(x_row<NB>(x, c.y, B), nb, vec, xv[1]);
      load_x_row<NB>(x_row<NB>(x, c.z, B), nb, vec, xv[2]);
      load_x_row<NB>(x_row<NB>(x, c.w, B), nb, vec, xv[3]);
    }
  }
};

// The null-mask walk's tiles: x at the tile's block column, 0 past n.
template <int NB>
struct BlockTiles {
  const float4* data;      // the warp's row group of tile 0, at the lane
  const int* tile_cols;
  long long tile_stride;   // float4s from one tile to the next
  const float* x;          // column b0 of x
  int n, B, nb, lane;
  bool vec;                // x's rows take 16-byte loads
  __device__ __forceinline__ void load(int t, float4 (&d)[8],
                                       long long& c) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = __ldg(data + t * tile_stride + i * ROW4);
    c = (long long)tile_cols[t] * 128 + 4 * lane;
  }
  __device__ __forceinline__ void gather(long long c,
                                         float (&xv)[4][NB]) const {
    if constexpr (NB == 1) {
      if (nb > 0)
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j][0] = c + j < n ? x[c + j] : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < n) load_x_row<NB>(x_row<NB>(x, c + j, B), nb, vec, xv[j]);
    }
  }
};

// A block row's tiles lo .. hi-1 in order into `part`.  A ring of
// PREFETCH tiles in registers (the loop unrolled by PREFETCH): before a
// tile's FMAs, the loads of the tile PREFETCH places on are issued and
// the next tile's x is gathered, so a tile's loads wait on no FMA and a
// run keeps PREFETCH tiles in flight.
template <int NB, class Tiles, class Cols>
__device__ __forceinline__ void walk_tiles(const Tiles& tiles, int lo, int hi,
                                           float (&part)[8][NB]) {
  float4 ring[PREFETCH][8];
  Cols cols[PREFETCH];
#pragma unroll
  for (int k = 0; k < PREFETCH; ++k)
    if (lo + k < hi) tiles.load(lo + k, ring[k], cols[k]);
  float xv[4][NB] = {};
  if (lo < hi) tiles.gather(cols[0], xv);
  for (int t = lo; t < hi; t += PREFETCH) {
#pragma unroll
    for (int k = 0; k < PREFETCH; ++k) {
      if (t + k >= hi) break;
      float4 d[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = ring[k][i];
      if (t + k + PREFETCH < hi)
        tiles.load(t + k + PREFETCH, ring[k], cols[k]);
      float xn[4][NB] = {};
      if (t + k + 1 < hi) tiles.gather(cols[(k + 1) % PREFETCH], xn);
      add_tile(part, d, xv, tiles.nb);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < NB; ++b) xv[j][b] = xn[j][b];
    }
  }
}

// Sum each row's partials over the warp and store row i of column b from
// lane 4i.  Each row's sum is warp_sum's butterfly (offsets 16, 8, 4, 2,
// 1), bitwise; the first three steps halve the rows a lane carries, so a
// column takes 9 shuffles, not 40.
template <int NB>
__device__ __forceinline__ void store_rows(const float (&part)[8][NB],
                                           int lane, float* out,
                                           long long col_stride, int nb) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b >= nb) break;
    float a[4], c[2];
#pragma unroll
    for (int j = 0; j < 4; ++j)          // rows 4*h16 + j
      a[j] = (h16 ? part[j + 4][b] : part[j][b]) +
             __shfl_xor_sync(FULL_MASK, h16 ? part[j][b] : part[j + 4][b], 16);
#pragma unroll
    for (int j = 0; j < 2; ++j)          // rows 4*h16 + 2*h8 + j
      c[j] = (h8 ? a[j + 2] : a[j]) +
             __shfl_xor_sync(FULL_MASK, h8 ? a[j] : a[j + 2], 8);
    float e = (h4 ? c[1] : c[0]) +       // row lane >> 2
              __shfl_xor_sync(FULL_MASK, h4 ? c[0] : c[1], 4);
    e += __shfl_xor_sync(FULL_MASK, e, 2);
    e += __shfl_xor_sync(FULL_MASK, e, 1);
    if ((lane & 3) == 0) out[b * col_stride + (lane >> 2)] = e;
  }
}

// A fill block's share of zeroing rows `from` .. R of every listed shard
// and column of the chunk, one V (float4 or float) a store, in a
// grid-stride loop over the fill blocks (those from tile_blocks on).  With
// float4, from and R must be multiples of 4.
template <class V>
__device__ __forceinline__ void zero_rows_past(float* y, const int* sids,
                                               int n_sids, int B, int b0,
                                               int nb, long long R,
                                               long long from,
                                               int tile_blocks) {
  constexpr int W = sizeof(V) / sizeof(float);
  const long long per = (R - from) / W;
  const long long total = (long long)n_sids * nb * per;
  const long long step = (long long)(gridDim.x - tile_blocks) * blockDim.x;
  for (long long q = (long long)(blockIdx.x - tile_blocks) * blockDim.x +
                     threadIdx.x;
       q < total; q += step) {
    const long long kb = q / per;
    const int k = (int)(kb / nb), b = (int)(kb % nb);
    V* row = reinterpret_cast<V*>(y + ((long long)sids[k] * B + b0 + b) * R +
                                  from);
    row[q - kb * per] = V{};
  }
}

// Blocks below tile_blocks: one warp per (k, mb < rb_used), k over sids.
// The others fill rows rb_used*BM .. R of every listed shard and column
// with zeros, a float4 a thread per step.
template <int NB>
__global__ void tile_contrib_kernel(const float* __restrict__ data,
                                    const int* __restrict__ xcol,
                                    const int* __restrict__ tile_ptr,
                                    const float* __restrict__ x,
                                    long long x_stride,
                                    const int* __restrict__ sids, int n_sids,
                                    int Tp, int Rb, int rb_used, int B,
                                    int tile_blocks,
                                    float* __restrict__ y) {
  constexpr int BM = 8, BN = 128;
  const long long R = (long long)Rb * BM;
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  if ((int)blockIdx.x >= tile_blocks) {
    zero_rows_past<float4>(y, sids, n_sids, B, b0, nb, R,
                           (long long)rb_used * BM, tile_blocks);
    return;
  }
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)n_sids * rb_used) return;
  const int k = (int)(item / rb_used), mb = (int)(item % rb_used);
  const int sid = sids[k];
  const int* ptr = tile_ptr + (long long)sid * (Rb + 1);
  const long long tile0 = (long long)sid * Tp;
  const FlatTiles<NB> tiles{
      reinterpret_cast<const float4*>(data + tile0 * BM * BN) + lane,
      reinterpret_cast<const int4*>(xcol + tile0 * BN) + lane,
      shard_x(x, x_stride, sid, b0), B, nb, x_rows_vec(x, B)};
  float part[BM][NB] = {};
  walk_tiles<NB, FlatTiles<NB>, int4>(tiles, ptr[mb], ptr[mb + 1], part);
  store_rows(part, lane,
             y + ((long long)sid * B + b0) * R + (long long)mb * BM, R, nb);
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
  const float* xv = walk_x<NB>(x, b0, n);
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
        xf[k][b] = jf[k] >= 0 && b < nb
                         ? x_row<NB>(xv, xc[k] + j, B)[b] : 0.f;
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
                acc[b] = fmaf(v[j], x_row<NB>(xv, xc[k] + 32 * q + j, B)[b],
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
              acc[b] = fmaf(d, x_row<NB>(xv, xc[k] + j, B)[b], acc[b]);
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
// is read, lanes across the row (walk_tiles), one warp per (block row,
// group of 8 rows).
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
  const BlockTiles<NB> tiles{
      reinterpret_cast<const float4*>(data + (long long)g * RG * BN) + lane,
      tile_cols, (long long)bm * BN / 4, walk_x<NB>(x, b0, n), n, B, nb,
      lane, x_rows_vec(x, B)};
  float part[RG][NB] = {};
  walk_tiles<NB, BlockTiles<NB>, long long>(tiles, tile_ptr[mb],
                                            tile_ptr[mb + 1], part);
  store_rows(part, lane,
             y + (long long)b0 * Mb * bm + (long long)mb * bm + g * RG,
             (long long)Mb * bm, nb);
}

// -- the general walks: any tile shape (bm, bn), bm, bn >= 1 --------------
//
// They read what the fast walks read, with every lane busy at the shapes
// users pick, and several items' loads in flight.
//
// The masked walk (tile_walk_general_kernel) is the fast walk's lane layout
// made general (MaskLayout).  A warp owns a group of RG rows of a block
// row, RG the largest power of two <= GENERAL_GROUP dividing bm, so every
// group is full and TPS = 32 / RG tile slots fill the warp.  A tile row
// goes in P pieces of up to 128 columns, the fast walk's row; item k of a
// block row is piece k % P of tile t_lo + k / P, and lane (u, r) owns row
// g*RG + r of the items u, u + TPS, ...  An item's mask bytes (bn / 8 a
// row, at most 16 a piece) come in aligned loads of W bytes, W the largest
// power of two <= 16 dividing bn / 8: one load a piece but where bn / 8
// has an odd factor (bn = 40: single bytes).  tile_cols[t] is read once
// an item.  Then only the marked cells, in ascending column, as the fast
// walk reads them (first_lone_cell, a full quarter as eight 16-byte
// loads).  The masks and first cells of GENERAL_STEPS items are loaded
// before any is added; one item a lane at a time, with few registers and
// so many warps, was the fastest.
//
// The null-mask walk (tile_walk_general_dense_kernel) and tile_contrib's
// (tile_contrib_general_kernel) read every cell (CellLayout).  A load is V
// cells: 4 (16 bytes) where bn % 4 == 0, else 1; a tile row is CV = bn / V
// loads.  LR lanes take a row's loads (LR the least power of two >= CV, at
// most 32; a row of more loads goes in NC chunks of LR), a warp pass holds
// RS rows (RS <= GENERAL_ROWS), and where its rows leave lanes over, TPS
// tile slots.  A warp holds G = RS * RPL <= GENERAL_ROWS rows: few rows a
// warp make many warps, which a short walk over a long block row needs.
// Item k of a block row is chunk k % NC of tile t_lo + k / NC; lane
// (u, r, v) owns rows g*G + r + RS*i (i < RPL) of the items u, u + TPS, ...,
// and load v of each.  One x gather feeds RPL rows and RHS_CHUNK columns.
// A ring of GENERAL_PREFETCH items sits in registers: an item's loads are
// issued that many items ahead, and the next item's x is gathered before
// this item's FMAs.
//
// Each lane adds its cells in the order above; a row's lanes end in a fixed
// butterfly over the tile-slot (and cell) bits of the lane.  Each column's
// adds run in this order whatever the number of columns, so batched columns
// equal the single-vector call bitwise.  No atomics.

__host__ __device__ inline int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

struct MaskLayout {
  int RG;       // rows a warp: the largest power of two <= GENERAL_GROUP
                // dividing bm
  int TPS;      // tile slots
  int P;        // pieces of up to 128 columns a tile row
  int groups;   // warps a block row
  __host__ __device__ MaskLayout(int bm, int bn)
      : RG((bm & -bm) < GENERAL_GROUP ? (bm & -bm) : GENERAL_GROUP),
        TPS(WARP / RG), P((bn + 127) / 128), groups(bm / RG) {}
};

struct CellLayout {
  int V, CV;    // cells a load, loads a tile row
  int LR, NC;   // lanes a row, chunks of LR loads a row
  int RS, TPS;  // row slots and tile slots of a warp pass
  int RPL, G;   // rows a lane (a power of two), rows a warp
                // (<= GENERAL_ROWS)
  int groups;   // warps a block row
  __host__ __device__ CellLayout(int bm, int bn) {
    V = bn % 4 == 0 ? 4 : 1;
    CV = bn / V;
    LR = pow2_ceil(CV < WARP ? CV : WARP);
    NC = (CV + LR - 1) / LR;
    int rows = pow2_ceil(bm);
    if (rows > GENERAL_ROWS) rows = GENERAL_ROWS;
    RS = WARP / LR < rows ? WARP / LR : rows;
    TPS = WARP / (LR * RS);
    const int per = pow2_ceil((bm + RS - 1) / RS);
    RPL = per < GENERAL_ROWS / RS ? per : GENERAL_ROWS / RS;
    G = RS * RPL;
    groups = (bm + G - 1) / G;
  }
};

// Bytes 0 .. nbytes-1 (nbytes <= 16) of a mask row piece at m, in loads of
// W bytes (m aligned to W), little-endian into four words, zeros past.
__device__ __forceinline__ uint4 load_mask_piece(const unsigned char* m,
                                                 int nbytes, int W) {
  if (W == 16) return __ldg(reinterpret_cast<const uint4*>(m));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (W == 8) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (8 * k < nbytes) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(m) + k);
        w[2 * k] = v.x, w[2 * k + 1] = v.y;
      }
  } else if (W == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * k < nbytes)
        w[k] = __ldg(reinterpret_cast<const unsigned*>(m) + k);
  } else if (W == 2) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (2 * k < nbytes)
        w[k / 2] |= (unsigned)__ldg(reinterpret_cast<const unsigned short*>(m)
                                    + k) << (16 * (k % 2));
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < nbytes) w[k / 4] |= (unsigned)__ldg(m + k) << (8 * (k % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// tile_walk_spmv with a mask at a shape the fast walk does not take: warp
// item (mb, g) over Mb block rows of MaskLayout::groups groups.
template <int NB>
__global__ void tile_walk_general_kernel(
    const float* __restrict__ data, const unsigned char* __restrict__ mask,
    const int* __restrict__ tile_cols, const int* __restrict__ tile_ptr,
    const float* __restrict__ x, int Mb, int bm, int bn, int n, int B,
    float* __restrict__ y) {
  constexpr int S = GENERAL_STEPS;
  const MaskLayout L(bm, bn);
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)Mb * L.groups) return;
  const int mb = (int)(item / L.groups), g = (int)(item % L.groups);
  const int r = lane % L.RG, u = lane / L.RG, row = g * L.RG + r;
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const float* xv = walk_x<NB>(x, b0, n);
  const int MB = bn / 8;                     // mask bytes a tile row
  const int W = min(MB & -MB, 16);
  const int lo = tile_ptr[mb];
  const int items = (tile_ptr[mb + 1] - lo) * L.P;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int k0 = u; k0 < items; k0 += L.TPS * S) {
    // S items at once: their masks and columns, then the first lone cell
    // of each, all loaded before any is used
    uint4 m[S];
    long long xc[S], dr[S];
    int jf[S];
    float df[S], xf[S][NB];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + L.TPS * s;
      m[s] = make_uint4(0u, 0u, 0u, 0u);
      xc[s] = 0, dr[s] = 0;
      if (k < items) {
        const int t = lo + (L.P == 1 ? k : k / L.P);
        const int p = L.P == 1 ? 0 : k % L.P;
        const long long tr = (long long)t * bm + row;   // the tile row
        m[s] = load_mask_piece(mask + tr * MB + 16 * p, min(16, MB - 16 * p),
                               W);
        xc[s] = (long long)tile_cols[t] * bn + 128 * p;
        dr[s] = tr * bn + 128 * p;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int f = first_lone_cell(m[s]);
      jf[s] = xc[s] + f < n ? f : -1;          // a mask marks no cell past x
      const int j = max(jf[s], 0);
      df[s] = jf[s] >= 0 ? data[dr[s] + j] : 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        xf[s][b] = jf[s] >= 0 && b < nb
                         ? x_row<NB>(xv, xc[s] + j, B)[b] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* drow = data + dr[s];
      const unsigned words[4] = {m[s].x, m[s].y, m[s].z, m[s].w};
      if (jf[s] >= 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b < nb) acc[b] = fmaf(df[s], xf[s][b], acc[b]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned bits = column_bits(words[q]);
        if (jf[s] >> 5 == q) bits &= bits - 1;    // the cell done above
        if (bits == ~0u && xc[s] + 32 * (q + 1) <= n) {
          // a full quarter: eight 16-byte loads, the same in-order FMAs
          float v[32];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float4 d4 =
                __ldg(reinterpret_cast<const float4*>(drow + 32 * q) + c);
            v[4 * c] = d4.x, v[4 * c + 1] = d4.y, v[4 * c + 2] = d4.z,
                    v[4 * c + 3] = d4.w;
          }
#pragma unroll
          for (int j = 0; j < 32; ++j)
#pragma unroll
            for (int b = 0; b < NB; ++b)
              if (b < nb)
                acc[b] = fmaf(v[j], x_row<NB>(xv, xc[s] + 32 * q + j, B)[b],
                              acc[b]);
          continue;
        }
        while (bits) {              // the other marked cells, ascending
          const int j = 32 * q + __ffs(bits) - 1;
          bits &= bits - 1;
          if (xc[s] + j >= n) break;   // a mask marks no cell past x
          const float d = drow[j];
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (b < nb)
              acc[b] = fmaf(d, x_row<NB>(xv, xc[s] + j, B)[b], acc[b]);
        }
      }
    }
  }
  // the TPS tile slots of each row, in a fixed butterfly
  for (int off = L.RG; off < WARP; off *= 2)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      acc[b] += __shfl_xor_sync(FULL_MASK, acc[b], off);
  if (u == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb)
        y[(long long)(b0 + b) * Mb * bm + (long long)mb * bm + row] = acc[b];
  }
}

// The cells of a V-cell load: a float4 or a float, and its x positions.
template <int V> struct CellVec;
template <> struct CellVec<4> { using F = float4; using I = int4; };
template <> struct CellVec<1> { using F = float; using I = int; };

__device__ __forceinline__ float cell(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float cell(float v, int) { return v; }
__device__ __forceinline__ int cell(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ int cell(int v, int) { return v; }

// The null-mask walk's cells: x at the tile's block column, 0 past n.
template <int NB, int V>
struct GeneralBlockCells {
  using F = typename CellVec<V>::F;
  using Pos = long long;          // x column of the load's first cell
  const float* data;
  const int* tile_cols;
  const float* x;                 // column b0 of x
  int bm, bn, n, B, nb;
  bool vec;                       // x's rows take 16-byte loads
  __device__ __forceinline__ F load(int t, int row, int w) const {
    return __ldg(reinterpret_cast<const F*>(
                     data + ((long long)t * bm + row) * bn) + w);
  }
  __device__ __forceinline__ Pos pos(int t, int w) const {
    return (long long)tile_cols[t] * bn + V * w;
  }
  __device__ __forceinline__ void gather(Pos c, float (&xv)[V][NB]) const {
    if constexpr (NB == 1) {
      if (nb > 0)
#pragma unroll
        for (int j = 0; j < V; ++j) xv[j][0] = c + j < n ? x[c + j] : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c + j < n) load_x_row<NB>(x_row<NB>(x, c + j, B), nb, vec, xv[j]);
    }
  }
};

// tile_contrib's cells: x through the lane positions xcol.
template <int NB, int V>
struct GeneralFlatCells {
  using F = typename CellVec<V>::F;
  using Pos = typename CellVec<V>::I;
  const float* data;              // tile 0 of the shard
  const int* xcol;                // tile 0's lane positions
  const float* x;                 // column b0 of the shard's x buffer
  int bm, bn, B, nb;
  bool vec;                       // x's rows take 16-byte loads
  __device__ __forceinline__ F load(int t, int row, int w) const {
    return __ldg(reinterpret_cast<const F*>(
                     data + ((long long)t * bm + row) * bn) + w);
  }
  __device__ __forceinline__ Pos pos(int t, int w) const {
    return __ldg(reinterpret_cast<const Pos*>(xcol + (long long)t * bn) + w);
  }
  __device__ __forceinline__ void gather(const Pos& c,
                                         float (&xv)[V][NB]) const {
    if constexpr (NB == 1) {
      if (nb > 0)
#pragma unroll
        for (int j = 0; j < V; ++j) xv[j][0] = x[cell(c, j)];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        load_x_row<NB>(x_row<NB>(x, cell(c, j), B), nb, vec, xv[j]);
    }
  }
};

// Tiles lo .. hi-1 of a block row, the rows of group g the lane owns, into
// `part` (a row and a column each), in the order set out above.
template <int NB, int V, int R, class Cells>
__device__ __forceinline__ void cells_walk(const Cells& c, const CellLayout& L,
                                           int lo, int hi, int g, int bm,
                                           float (&part)[R][NB]) {
  using F = typename CellVec<V>::F;
  using Pos = typename Cells::Pos;
  constexpr int GP = GENERAL_PREFETCH;
  const int lane = threadIdx.x % WARP;
  const int v = lane % L.LR, r = (lane / L.LR) % L.RS;
  const int u = lane / (L.LR * L.RS), r0 = g * L.G + r;
  const int items = (hi - lo) * L.NC;
  // item k: tile lo + k / NC, the lane's load (k % NC) * LR + v of it
  auto load_of = [&](int k) { return (L.NC == 1 ? 0 : k % L.NC) * L.LR + v; };
  auto load = [&](int k, F (&d)[R], Pos& p) {
    const int t = lo + (L.NC == 1 ? k : k / L.NC), w = load_of(k);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      d[i] = F{};
      if (w < L.CV && r0 + L.RS * i < bm) d[i] = c.load(t, r0 + L.RS * i, w);
    }
    p = Pos{};
    if (w < L.CV) p = c.pos(t, w);
  };
  F ring[GP][R];
  Pos pos[GP];
#pragma unroll
  for (int p = 0; p < GP; ++p)
    if (u + L.TPS * p < items) load(u + L.TPS * p, ring[p], pos[p]);
  float xv[V][NB] = {};
  if (u < items && load_of(u) < L.CV) c.gather(pos[0], xv);
  for (int k0 = u; k0 < items; k0 += L.TPS * GP) {
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      const int k = k0 + L.TPS * p;
      if (k >= items) break;
      F d[R];
#pragma unroll
      for (int i = 0; i < R; ++i) d[i] = ring[p][i];
      if (k + L.TPS * GP < items) load(k + L.TPS * GP, ring[p], pos[p]);
      float xn[V][NB] = {};
      const int kn = k + L.TPS;
      if (kn < items && load_of(kn) < L.CV) c.gather(pos[(p + 1) % GP], xn);
      if (load_of(k) < L.CV) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if (b >= c.nb) break;
#pragma unroll
            for (int j = 0; j < V; ++j)
              part[i][b] = fmaf(cell(d[i], j), xv[j][b], part[i][b]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int b = 0; b < NB; ++b) xv[j][b] = xn[j][b];
    }
  }
}

// Each of the lane's rows summed over the lanes that share it (the
// butterfly over the tile-slot and cell bits, offsets 16 .. 1; every lane
// at LR = 32, RS = 1, as warp_sum), row g*G + r + RS*i of column b stored
// by lane (0, r, 0) at out[b * col_stride + row].
template <int NB, int R>
__device__ __forceinline__ void store_cells(
    const float (&part)[R][NB], const CellLayout& L, int g, int bm, int nb,
    float* out, long long col_stride) {
  const int lane = threadIdx.x % WARP;
  const int v = lane % L.LR, r = (lane / L.LR) % L.RS;
  const int u = lane / (L.LR * L.RS);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = g * L.G + r + L.RS * i;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb) break;
      float s = part[i][b];
#pragma unroll
      for (int off = WARP / 2; off > 0; off /= 2)
        if (off < L.LR || off >= L.LR * L.RS)
          s += __shfl_xor_sync(FULL_MASK, s, off);
      if (u == 0 && v == 0 && row < bm) out[b * col_stride + row] = s;
    }
  }
}

// tile_walk_spmv without a mask at a shape the fast walk does not take:
// warp item (mb, g) over Mb block rows of CellLayout::groups groups, R =
// CellLayout::RPL rows a lane.
template <int NB, int V, int R>
__global__ void tile_walk_general_dense_kernel(
    const float* __restrict__ data, const int* __restrict__ tile_cols,
    const int* __restrict__ tile_ptr, const float* __restrict__ x, int Mb,
    int bm, int bn, int n, int B, float* __restrict__ y) {
  const CellLayout L(bm, bn);
  const int warp = threadIdx.x / WARP;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)Mb * L.groups) return;
  const int mb = (int)(item / L.groups), g = (int)(item % L.groups);
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const GeneralBlockCells<NB, V> c{data, tile_cols, walk_x<NB>(x, b0, n), bm,
                                   bn, n, B, nb, x_rows_vec(x, B)};
  float part[R][NB] = {};
  cells_walk<NB, V, R>(c, L, tile_ptr[mb], tile_ptr[mb + 1], g, bm, part);
  const long long rows = (long long)Mb * bm;
  store_cells(part, L, g, bm, nb, y + b0 * rows + (long long)mb * bm, rows);
}

// tile_contrib at a shape other than (8, 128): blocks below tile_blocks
// hold warp items (k, mb < rb_used, g); the others zero rows
// rb_used*bm .. Rb*bm of every listed shard and column, a float a store
// (bm and so the rows' starts are not multiples of 4 in general).  R =
// CellLayout::RPL rows a lane.
template <int NB, int V, int R>
__global__ void tile_contrib_general_kernel(
    const float* __restrict__ data, const int* __restrict__ xcol,
    const int* __restrict__ tile_ptr, const float* __restrict__ x,
    long long x_stride, const int* __restrict__ sids, int n_sids, int Tp,
    int Rb, int rb_used, int bm, int bn, int B, int tile_blocks,
    float* __restrict__ y) {
  const long long rows = (long long)Rb * bm;
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  if ((int)blockIdx.x >= tile_blocks) {
    zero_rows_past<float>(y, sids, n_sids, B, b0, nb, rows,
                          (long long)rb_used * bm, tile_blocks);
    return;
  }
  const CellLayout L(bm, bn);
  const int warp = threadIdx.x / WARP;
  const long long per_shard = (long long)rb_used * L.groups;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)n_sids * per_shard) return;
  const int k = (int)(item / per_shard);
  const long long rem = item % per_shard;
  const int mb = (int)(rem / L.groups), g = (int)(rem % L.groups);
  const int sid = sids[k];
  const int* ptr = tile_ptr + (long long)sid * (Rb + 1);
  const long long tile0 = (long long)sid * Tp;
  const GeneralFlatCells<NB, V> c{data + tile0 * bm * bn, xcol + tile0 * bn,
                                  shard_x(x, x_stride, sid, b0), bm, bn, B,
                                  nb, x_rows_vec(x, B)};
  float part[R][NB] = {};
  cells_walk<NB, V, R>(c, L, ptr[mb], ptr[mb + 1], g, bm, part);
  store_cells(part, L, g, bm, nb,
              y + ((long long)sid * B + b0) * rows + (long long)mb * bm, rows);
}

// The null-mask general walk with R rows a lane, R the layout's RPL (a
// power of two <= GENERAL_ROWS).
template <int NB, int V, int R = 1>
void launch_dense_walk(int rpl, dim3 grid, cudaStream_t s, const float* data,
                       const int* tile_cols, const int* tile_ptr,
                       const float* x, int Mb, int bm, int bn, int n, int B,
                       float* y) {
  if constexpr (R < GENERAL_ROWS)
    if (rpl > R)
      return launch_dense_walk<NB, V, 2 * R>(rpl, grid, s, data, tile_cols,
                                             tile_ptr, x, Mb, bm, bn, n, B,
                                             y);
  tile_walk_general_dense_kernel<NB, V, R><<<grid, WARPS_PER_BLOCK * WARP, 0,
                                             s>>>(data, tile_cols, tile_ptr,
                                                  x, Mb, bm, bn, n, B, y);
}

// One launch of the tile walk for NB columns a thread: the fast walks at
// (8k, 128) tiles, the general walks at any other shape.
template <int NB>
void launch_tile_walk(bool fast, dim3 grid, cudaStream_t s, const float* data,
                      const unsigned char* mask, const int* tile_cols,
                      const int* tile_ptr, const float* x, int Mb, int bm,
                      int bn, int n, int B, float* y) {
  constexpr int threads = WARPS_PER_BLOCK * WARP;
  if (fast && mask)
    tile_walk_kernel<NB><<<grid, threads, 0, s>>>(data, mask, tile_cols,
                                                  tile_ptr, x, Mb, bm, n, B,
                                                  y);
  else if (fast)
    tile_walk_dense_kernel<NB><<<grid, threads, 0, s>>>(
        data, tile_cols, tile_ptr, x, Mb, bm, n, B, y);
  else if (mask)
    tile_walk_general_kernel<NB><<<grid, threads, 0, s>>>(
        data, mask, tile_cols, tile_ptr, x, Mb, bm, bn, n, B, y);
  else if (bn % 4 == 0)
    launch_dense_walk<NB, 4>(CellLayout(bm, bn).RPL, grid, s, data,
                             tile_cols, tile_ptr, x, Mb, bm, bn, n, B, y);
  else
    launch_dense_walk<NB, 1>(CellLayout(bm, bn).RPL, grid, s, data,
                             tile_cols, tile_ptr, x, Mb, bm, bn, n, B, y);
}

// tile_contrib's general kernel for V cells a load and R rows a lane (R
// the layout's RPL), NB columns a thread.
template <int V, int R = 1>
void launch_contrib_cells(int rpl, dim3 grid, cudaStream_t s,
                          const float* data, const int* xcol,
                          const int* tile_ptr, const float* x,
                          long long x_stride, const int* sids, int n_sids,
                          int Tp, int Rb, int rb_used, int bm, int bn, int B,
                          int tile_blocks, float* y) {
  if constexpr (R < GENERAL_ROWS)
    if (rpl > R)
      return launch_contrib_cells<V, 2 * R>(
          rpl, grid, s, data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp,
          Rb, rb_used, bm, bn, B, tile_blocks, y);
  constexpr int threads = WARPS_PER_BLOCK * WARP;
  if (B == 1)
    tile_contrib_general_kernel<1, V, R><<<grid, threads, 0, s>>>(
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, bm,
        bn, B, tile_blocks, y);
  else
    tile_contrib_general_kernel<RHS_CHUNK, V, R><<<grid, threads, 0, s>>>(
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, bm,
        bn, B, tile_blocks, y);
}

// tile_contrib at a shape other than (8, 128): the grid of the fast path
// with CellLayout::groups warps a block row, and fill blocks of
// FILL_STORES 4-byte stores a thread.
int launch_contrib_general(const float* data, const int* xcol,
                           const int* tile_ptr, const float* x,
                           long long x_stride, const int* sids, int n_sids,
                           int Tp, int Rb, int rb_used, int bm, int bn,
                           int B, float* y, cudaStream_t s) {
  const CellLayout L(bm, bn);
  const long long items = (long long)n_sids * rb_used * L.groups;
  const long long tile_blocks =
      (items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const int nb = B < RHS_CHUNK ? B : RHS_CHUNK;   // columns of chunk 0
  const long long fill = (long long)n_sids * nb * (Rb - rb_used) * bm;
  const long long per_block =
      (long long)WARPS_PER_BLOCK * WARP * FILL_STORES;
  const long long fill_blocks = (fill + per_block - 1) / per_block;
  if (tile_blocks + fill_blocks == 0) return 0;
  const dim3 grid((unsigned)(tile_blocks + fill_blocks),
                  (unsigned)((B + RHS_CHUNK - 1) / RHS_CHUNK));
  if (bn % 4 == 0)
    launch_contrib_cells<4>(L.RPL, grid, s, data, xcol, tile_ptr, x,
                            x_stride, sids, n_sids, Tp, Rb, rb_used, bm, bn,
                            B, (int)tile_blocks, y);
  else
    launch_contrib_cells<1>(L.RPL, grid, s, data, xcol, tile_ptr, x,
                            x_stride, sids, n_sids, Tp, Rb, rb_used, bm, bn,
                            B, (int)tile_blocks, y);
  return (int)cudaGetLastError();
}

}  // namespace

// data (T, bm, bn), mask (T, bm, bn/8) packed occupancy or null (every
// cell occupied), tile_cols (T,), tile_ptr (Mb+1,), x (n, B),
// y (B, Mb*bm); bm, bn >= 1, and bn % 8 == 0 with a mask.  One warp per
// (block row, group of 8 rows) on the fast walks, of MaskLayout's or
// CellLayout's groups on the general ones.
RT_API int rt_tile_walk_spmv(const float* data, const unsigned char* mask,
                             const int* tile_cols, const int* tile_ptr,
                             const float* x, int Mb, int bm, int bn, int n,
                             int B, float* y, void* stream) {
  if (bm <= 0 || bn <= 0 || (mask && bn % 8))
    return (int)cudaErrorInvalidValue;
  const bool fast = bn == 128 && bm % 8 == 0;
  const int groups = fast   ? bm / 8
                     : mask ? MaskLayout(bm, bn).groups
                            : CellLayout(bm, bn).groups;
  const long long items = (long long)Mb * groups;
  if (items == 0 || B == 0) return 0;
  const unsigned blocks =
      (unsigned)((items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const cudaStream_t s = (cudaStream_t)stream;
  if (B == 1)
    launch_tile_walk<1>(fast, dim3(blocks), s, data, mask, tile_cols,
                        tile_ptr, x, Mb, bm, bn, n, B, y);
  else
    launch_tile_walk<RHS_CHUNK>(
        fast, dim3(blocks, (B + RHS_CHUNK - 1) / RHS_CHUNK), s, data, mask,
        tile_cols, tile_ptr, x, Mb, bm, bn, n, B, y);
  return (int)cudaGetLastError();
}

// tile_contrib's grid along x at (8, 128) tiles:
// ceil(n_sids * rb_used / WARPS_PER_BLOCK) tile blocks, then enough fill
// blocks to zero rows rb_used*BM .. R of every listed shard and column of
// a chunk, FILL_STORES 16-byte stores a thread.  Any other shape (BM,
// BN >= 1) takes launch_contrib_general.
RT_API int rt_tile_spmv(const float* data, const int* xcol,
                        const int* tile_ptr, const float* x,
                        long long x_stride, const int* sids, int n_sids,
                        int Tp, int Rb, int rb_used, int BM, int BN, int B,
                        float* y, void* stream) {
  if (BM <= 0 || BN <= 0 || rb_used < 0 || rb_used > Rb)
    return (int)cudaErrorInvalidValue;
  if (n_sids == 0 || B == 0) return 0;
  if (BM != 8 || BN != 128)
    return launch_contrib_general(data, xcol, tile_ptr, x, x_stride, sids,
                                  n_sids, Tp, Rb, rb_used, BM, BN, B, y,
                                  (cudaStream_t)stream);
  const long long items = (long long)n_sids * rb_used;
  const long long tile_blocks =
      (items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const int nb = B < RHS_CHUNK ? B : RHS_CHUNK;   // columns of chunk 0
  const long long fill = (long long)n_sids * nb * (Rb - rb_used) * BM / 4;
  const long long per_block =
      (long long)WARPS_PER_BLOCK * WARP * FILL_STORES;
  const long long fill_blocks = (fill + per_block - 1) / per_block;
  if (tile_blocks + fill_blocks == 0) return 0;
  const dim3 grid((unsigned)(tile_blocks + fill_blocks),
                  (unsigned)((B + RHS_CHUNK - 1) / RHS_CHUNK));
  const int threads = WARPS_PER_BLOCK * WARP;
  const cudaStream_t s = (cudaStream_t)stream;
  if (B == 1)
    tile_contrib_kernel<1><<<grid, threads, 0, s>>>(
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, B,
        (int)tile_blocks, y);
  else
    tile_contrib_kernel<RHS_CHUNK><<<grid, threads, 0, s>>>(
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, B,
        (int)tile_blocks, y);
  return (int)cudaGetLastError();
}
