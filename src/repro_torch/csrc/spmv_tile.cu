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
// overlap.  One load feeds RHS_CHUNK columns.
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
// other shape the reference takes goes to the general walks (below):
// plain warps over 8-row groups with lanes across the row in 32-cell
// strides, the mask read a byte at a time (a mask row is bn / 8 bytes, so
// the 16-byte mask load does not carry over), and tile_contrib's zero fill
// in 4-byte stores (bm * rows need not be a multiple of 4).
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
// Rows of a tile one warp of a general walk (any tile shape) owns.
constexpr int GROUP_ROWS = 8;

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

// tile_contrib's (8, 128) tiles: x through the lane positions xcol.
template <int NB>
struct FlatTiles {
  const float4* data;      // tile 0 of the shard, at the lane's cells
  const int4* xcol;        // tile 0's lane positions, at the lane's 4
  const float* x;          // column b0 of the shard's x buffer
  long long Lx;
  int nb;
  __device__ __forceinline__ void load(int t, float4 (&d)[8],
                                       int4& c) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      d[i] = __ldg(data + ((long long)t * 8 + i) * ROW4);
    c = __ldg(xcol + (long long)t * ROW4);
  }
  __device__ __forceinline__ void gather(const int4& c,
                                         float (&xv)[4][NB]) const {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb) break;
      const float* xb = x + b * Lx;
      xv[0][b] = xb[c.x], xv[1][b] = xb[c.y], xv[2][b] = xb[c.z],
      xv[3][b] = xb[c.w];
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
  int n, nb, lane;
  __device__ __forceinline__ void load(int t, float4 (&d)[8],
                                       long long& c) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = __ldg(data + t * tile_stride + i * ROW4);
    c = (long long)tile_cols[t] * 128 + 4 * lane;
  }
  __device__ __forceinline__ void gather(long long c,
                                         float (&xv)[4][NB]) const {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb) break;
      const float* xb = x + (long long)b * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j][b] = c + j < n ? xb[c + j] : 0.f;
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
                                    int Tp, int Rb, int rb_used, int Lx,
                                    int B, int tile_blocks,
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
      shard_x(x, x_stride, sid, b0, Lx), Lx, nb};
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
      tile_cols, (long long)bm * BN / 4, x + (long long)b0 * n, n, nb, lane};
  float part[RG][NB] = {};
  walk_tiles<NB, BlockTiles<NB>, long long>(tiles, tile_ptr[mb],
                                            tile_ptr[mb + 1], part);
  store_rows(part, lane,
             y + (long long)b0 * Mb * bm + (long long)mb * bm + g * RG,
             (long long)Mb * bm, nb);
}

// -- the general walks: any tile shape (bm, bn), bm, bn >= 1 --------------
//
// One warp per (block row, group of up to GROUP_ROWS rows): the last
// group of a block row is cut where bm % GROUP_ROWS != 0.  Lanes go across
// the tile row in strides of 32 cells: lane l takes cells l, l + 32, ...
// below bn (the last stride masked where bn % 32 != 0), of every row of its
// group, in each tile of the block row in tile order.  For a cell column j
// of tile t the lane first finds which of its group's rows read it (the
// masked walk: the row's mask byte j / 8, bit 7 - j % 8, read byte by byte
// since a mask row is only bn / 8 bytes; the null-mask walk and
// tile_contrib: every row), gathers x once for them (RHS_CHUNK columns
// from one cell load), then adds each such row's cell into its running
// partial.  Each row's 32 partials are summed once, at the end, with
// warp_sum's butterfly.  Each column's adds run in this fixed order, so
// batched columns equal the single-vector call bitwise.

// The masked walk's cells: only the marked ones, x at the tile's block
// column (a mask marks no cell past n).
struct MaskedCells {
  const float* data;
  const unsigned char* mask;
  const int* tile_cols;
  const float* x;          // column b0 of x
  long long col_stride;    // floats between two columns of x
  int bm, bn, n;
  __device__ __forceinline__ unsigned rows(long long t, int r0, int nr,
                                           int j) const {
    if ((long long)tile_cols[t] * bn + j >= n) return 0u;
    const unsigned char* m = mask + (t * bm + r0) * (bn / 8) + j / 8;
    unsigned on = 0u;
    for (int i = 0; i < nr; ++i)
      on |= (unsigned)((m[(long long)i * (bn / 8)] >> (7 - j % 8)) & 1) << i;
    return on;
  }
  __device__ __forceinline__ float xval(long long t, int j, int b) const {
    return x[b * col_stride + (long long)tile_cols[t] * bn + j];
  }
};

// The null-mask walk's cells (the Block-ELL shims' zero-padded slab):
// every cell, x at the tile's block column, 0 past n.
struct DenseCells {
  const float* data;
  const int* tile_cols;
  const float* x;          // column b0 of x
  long long col_stride;
  int bm, bn, n;
  __device__ __forceinline__ unsigned rows(long long, int, int nr,
                                           int) const {
    return (1u << nr) - 1u;
  }
  __device__ __forceinline__ float xval(long long t, int j, int b) const {
    const long long c = (long long)tile_cols[t] * bn + j;
    return c < n ? x[b * col_stride + c] : 0.f;
  }
};

// tile_contrib's cells: every cell of the shard's tiles, x through the
// lane positions xcol.
struct FlatCells {
  const float* data;       // tile 0 of the shard
  const int* xcol;         // tile 0's lane positions
  const float* x;          // column b0 of the shard's x buffer
  long long col_stride;
  int bm, bn;
  __device__ __forceinline__ unsigned rows(long long, int, int nr,
                                           int) const {
    return (1u << nr) - 1u;
  }
  __device__ __forceinline__ float xval(long long t, int j, int b) const {
    return x[b * col_stride + xcol[t * bn + j]];
  }
};

// Tiles lo .. hi-1 of a block row, rows r0 .. r0+nr-1 of each, into
// `part` (a row and a column each), in the order set out above.
template <int NB, class Cells>
__device__ __forceinline__ void general_walk(const Cells& c, int lo, int hi,
                                             int r0, int nr, int nb,
                                             float (&part)[GROUP_ROWS][NB]) {
  const int lane = threadIdx.x % WARP;
  for (long long t = lo; t < hi; ++t) {
    for (int j = lane; j < c.bn; j += WARP) {
      const unsigned on = c.rows(t, r0, nr, j);
      if (!on) continue;
      float xv[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) xv[b] = b < nb ? c.xval(t, j, b) : 0.f;
      const float* d = c.data + (t * c.bm + r0) * c.bn + j;
#pragma unroll
      for (int i = 0; i < GROUP_ROWS; ++i) {
        if (!(on >> i & 1u)) continue;
        const float v = d[(long long)i * c.bn];
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b < nb) part[i][b] = fmaf(v, xv[b], part[i][b]);
      }
    }
  }
}

// Each of the group's nr rows summed over the warp (warp_sum), row i of
// column b stored by lane i at out[b * col_stride + i].
template <int NB>
__device__ __forceinline__ void store_group(
    const float (&part)[GROUP_ROWS][NB], int nr, int nb, float* out,
    long long col_stride) {
  const int lane = threadIdx.x % WARP;
#pragma unroll
  for (int i = 0; i < GROUP_ROWS; ++i) {
    if (i >= nr) break;                         // warp-uniform
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb) break;
      const float v = warp_sum(part[i][b]);
      if (lane == i) out[b * col_stride + i] = v;
    }
  }
}

// tile_walk_spmv at a shape the fast walks do not take: warp item
// (mb, g) over Mb block rows of ceil(bm / GROUP_ROWS) groups.
template <int NB, bool MASKED>
__global__ void tile_walk_general_kernel(
    const float* __restrict__ data, const unsigned char* __restrict__ mask,
    const int* __restrict__ tile_cols, const int* __restrict__ tile_ptr,
    const float* __restrict__ x, int Mb, int bm, int bn, int n, int B,
    float* __restrict__ y) {
  const int warp = threadIdx.x / WARP;
  const int groups = (bm + GROUP_ROWS - 1) / GROUP_ROWS;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)Mb * groups) return;
  const int mb = (int)(item / groups), g = (int)(item % groups);
  const int r0 = g * GROUP_ROWS, nr = min(GROUP_ROWS, bm - r0);
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const float* xb = x + (long long)b0 * n;
  float part[GROUP_ROWS][NB] = {};
  if (MASKED)
    general_walk<NB>(MaskedCells{data, mask, tile_cols, xb, n, bm, bn, n},
                     tile_ptr[mb], tile_ptr[mb + 1], r0, nr, nb, part);
  else
    general_walk<NB>(DenseCells{data, tile_cols, xb, n, bm, bn, n},
                     tile_ptr[mb], tile_ptr[mb + 1], r0, nr, nb, part);
  const long long R = (long long)Mb * bm;
  store_group(part, nr, nb, y + b0 * R + (long long)mb * bm + r0, R);
}

// tile_contrib at a shape other than (8, 128): blocks below tile_blocks
// hold warp items (k, mb < rb_used, g); the others zero rows
// rb_used*bm .. R of every listed shard and column, a float a store (bm
// and so the rows' starts are not multiples of 4 in general).
template <int NB>
__global__ void tile_contrib_general_kernel(
    const float* __restrict__ data, const int* __restrict__ xcol,
    const int* __restrict__ tile_ptr, const float* __restrict__ x,
    long long x_stride, const int* __restrict__ sids, int n_sids, int Tp,
    int Rb, int rb_used, int bm, int bn, int Lx, int B, int tile_blocks,
    float* __restrict__ y) {
  const long long R = (long long)Rb * bm;
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  if ((int)blockIdx.x >= tile_blocks) {
    zero_rows_past<float>(y, sids, n_sids, B, b0, nb, R,
                          (long long)rb_used * bm, tile_blocks);
    return;
  }
  const int warp = threadIdx.x / WARP;
  const int groups = (bm + GROUP_ROWS - 1) / GROUP_ROWS;
  const long long per_shard = (long long)rb_used * groups;
  const long long item = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (item >= (long long)n_sids * per_shard) return;
  const int k = (int)(item / per_shard);
  const long long rem = item % per_shard;
  const int mb = (int)(rem / groups), g = (int)(rem % groups);
  const int r0 = g * GROUP_ROWS, nr = min(GROUP_ROWS, bm - r0);
  const int sid = sids[k];
  const int* ptr = tile_ptr + (long long)sid * (Rb + 1);
  const long long tile0 = (long long)sid * Tp;
  float part[GROUP_ROWS][NB] = {};
  general_walk<NB>(FlatCells{data + tile0 * bm * bn, xcol + tile0 * bn,
                             shard_x(x, x_stride, sid, b0, Lx), Lx, bm, bn},
                   ptr[mb], ptr[mb + 1], r0, nr, nb, part);
  store_group(part, nr, nb,
              y + ((long long)sid * B + b0) * R + (long long)mb * bm + r0, R);
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
    tile_walk_general_kernel<NB, true><<<grid, threads, 0, s>>>(
        data, mask, tile_cols, tile_ptr, x, Mb, bm, bn, n, B, y);
  else
    tile_walk_general_kernel<NB, false><<<grid, threads, 0, s>>>(
        data, mask, tile_cols, tile_ptr, x, Mb, bm, bn, n, B, y);
}

// tile_contrib at a shape other than (8, 128): the grid of the fast path
// with ceil(bm / GROUP_ROWS) warps a block row, and fill blocks of
// FILL_STORES 4-byte stores a thread.
int launch_contrib_general(const float* data, const int* xcol,
                           const int* tile_ptr, const float* x,
                           long long x_stride, const int* sids, int n_sids,
                           int Tp, int Rb, int rb_used, int bm, int bn,
                           int Lx, int B, float* y, cudaStream_t s) {
  const int groups = (bm + GROUP_ROWS - 1) / GROUP_ROWS;
  const long long items = (long long)n_sids * rb_used * groups;
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
  const int threads = WARPS_PER_BLOCK * WARP;
  if (B == 1)
    tile_contrib_general_kernel<1><<<grid, threads, 0, s>>>(
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, bm,
        bn, Lx, B, (int)tile_blocks, y);
  else
    tile_contrib_general_kernel<RHS_CHUNK><<<grid, threads, 0, s>>>(
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, bm,
        bn, Lx, B, (int)tile_blocks, y);
  return (int)cudaGetLastError();
}

}  // namespace

// data (T, bm, bn), mask (T, bm, bn/8) packed occupancy or null (every
// cell occupied), tile_cols (T,), tile_ptr (Mb+1,), x (B, n),
// y (B, Mb*bm); bm, bn >= 1, and bn % 8 == 0 with a mask.  One warp per
// (block row, group of 8 rows) on the fast walks, of GROUP_ROWS rows on
// the general ones.
RT_API int rt_tile_walk_spmv(const float* data, const unsigned char* mask,
                             const int* tile_cols, const int* tile_ptr,
                             const float* x, int Mb, int bm, int bn, int n,
                             int B, float* y, void* stream) {
  if (bm <= 0 || bn <= 0 || (mask && bn % 8))
    return (int)cudaErrorInvalidValue;
  const bool fast = bn == 128 && bm % 8 == 0;
  const int groups = fast ? bm / 8 : (bm + GROUP_ROWS - 1) / GROUP_ROWS;
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
                        int Tp, int Rb, int rb_used, int BM, int BN, int Lx,
                        int B, float* y, void* stream) {
  if (BM <= 0 || BN <= 0 || rb_used < 0 || rb_used > Rb)
    return (int)cudaErrorInvalidValue;
  if (n_sids == 0 || B == 0) return 0;
  if (BM != 8 || BN != 128)
    return launch_contrib_general(data, xcol, tile_ptr, x, x_stride, sids,
                                  n_sids, Tp, Rb, rb_used, BM, BN, Lx, B, y,
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
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, Lx,
        B, (int)tile_blocks, y);
  else
    tile_contrib_kernel<RHS_CHUNK><<<grid, threads, 0, s>>>(
        data, xcol, tile_ptr, x, x_stride, sids, n_sids, Tp, Rb, rb_used, Lx,
        B, (int)tile_blocks, y);
  return (int)cudaGetLastError();
}
