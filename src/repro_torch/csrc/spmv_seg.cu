// Nonzero-balanced segmented SpMV: per-chunk prefix sums + carry fix-up.
//
// Replaces: src/repro/kernels/spmv_seg.py seg_psum (_seg_kernel,
// pallas_call at :56), and the jnp carry fix-ups that followed it on the
// device path (src/repro/kernels/ops.py _seg_fixup :158 and
// _split_flat_fixup :275, which are jnp glue, not TPU kernels).
//
// seg_psum:  psum[k, b, c, l] = sum_{j <= l} vals[s, c, j] * x[s, cols[s, c, j], b]
// seg_fixup: out[o, b, t, r] = sum over r's pieces of split t of
//            psum[k, b, chunk, hi] - psum[k, b, chunk, lo - 1]
// seg_piece_sums: d[k, b, p] = psum[k, b, chunk, hi] - psum[k, b, chunk, lo - 1]
//            for each piece p of shard s, psum never stored
// seg_fixup over d (DIFFS): y[s, b, r] = sum over r's pieces of d[k, b, p]
// split_fixup: y[s, b, r] = sum over t in split order of seg_fixup's
//            out[., b, t, r], for the splits t that r has pieces in
//
// The seg family runs seg_piece_sums, then seg_fixup over d; the split
// family (pieces split-ordered within a row, so not in chunk order) runs
// seg_psum -> split_fixup, seg_fixup's kernel writing y: each row's runs
// folded in split order as the thread meets them, bitwise seg_fixup into
// (n, B, NS, R) partials and then split_combine, which stay as the
// reference's counterparts.  seg_piece_sums replaces seg_psum
// and the fix-up's psum gathers on the seg path, and is bitwise that pair:
// the same loads, the same scan, the same one subtraction a piece, and the
// fix-up's in-order sums of the same differences.
//
// What bounds them on the H100: bytes.  The scan reads 8 bytes of
// vals + cols and gathers 4 bytes of x per element and writes the 4-byte
// prefix sum; the fix-up reads a 20-byte piece record and two psum values
// per piece and writes every (row, split) output, most of them zeros at
// NS = 64.  The TPU kernel scanned a whole (8, 512) tile per grid step in
// VMEM; a Hopper block has no sequential grid to carry state in, so each
// chunk is scanned independently and the cross-chunk carry is the
// fix-up's job.
//
// seg_psum: one warp per chunk, CHUNKS_PER_BLOCK chunks a block, no block
// barrier.  The warp walks its chunk in steps of 128 elements: each lane
// loads 4 contiguous elements of vals and cols as one 16-byte load each
// (neighbouring lanes on neighbouring addresses), gathers x for them and
// scans its 4 products serially; a shuffle scan over the 32 lane totals
// and the carry of the previous step (lane 31's last value) complete the
// prefix sums, stored as one 16-byte store a lane.  The loads of vals and
// cols of STEPS_AHEAD steps go out before the first of them is scanned, so
// a 512-element chunk waits on one round of them, not four; at B = 1 so do
// the steps' x gathers.  A thread keeps up to RHS_CHUNK columns, so one
// load of vals and cols feeds every column of an (N, B) chunk, and x being
// batch-minor, an element's columns are one row of x: at B = 8 two 16-byte
// loads of one sector, not 8 gathers into 8 planes.  A batched scan
// gathers ROWS_AHEAD steps' rows (4 x NB floats a step) at a time, then
// scans each column of those steps.  Every add is an explicit
// round-to-nearest intrinsic in a fixed order: deterministic, and column
// b of a batched call equals the single-vector call bitwise.  A chunk of
// any length L % 4 == 0 is walked this way (the carry spans the steps), and
// split_psum runs this scan (launch_seg_psum) on its flattened slab.
//
// seg_fixup: the pieces of shard k's row r are the contiguous run
// [piece_ptr[r], piece_ptr[r+1]) of the row-ordered piece table,
// split-ordered within the row, so the ranges come from one coalesced
// read of piece_ptr; nothing is searched, and a row without pieces costs
// that read and its zero stores.  Into partials a row stores NS values a
// column, nearly all zeros at NS = 64 (254 MB a call on powerlaw_tail);
// into y (split_fixup, `to_y`) it stores one: at each change of split, and
// at the row's end, the run's sum is added to a row sum that starts at +0
// (split_combine's sum without its +0 terms, which change nothing: a sum
// from +0 in round-to-nearest is never -0).  Over seg_piece_sums' d a row's
// differences are contiguous too, d[ptr[r]] .. d[ptr[r+1] - 1], and no
// record is read.  A warp owns 32 consecutive rows of a shard:
//   * short rows (at most LONG_ROW pieces): the lane walks its own row.
//     It loads all its records, then all their psum pairs (loads that
//     wait on nothing but the record), then adds the differences in piece
//     order from 0, restarting at each change of split, and writes all NS
//     outputs of its row: the run's sum where split t has pieces, 0 where
//     it has none.  Lanes write neighbouring rows, so each store of split
//     t is coalesced.
//   * long rows (more than LONG_ROW pieces) are found with __ballot_sync
//     (their lanes store the rows' zeros) and then dealt out to the
//     block's FIXUP_WARPS warps in turn: a matrix's monster rows are
//     often neighbours, and one warp would walk them one after another.
//     Over d and into partials a warp takes its row in rounds of ROUND =
//     LONG_LOADS * 32 pieces: lane i loads records base + 32u + i and
//     their psum pairs and puts the splits and differences in the warp's
//     stage in shared memory; the next round's records go out; lane b adds
//     column b's differences in piece order from the stage (4 a 16-byte
//     read), leaving each piece's running sum there; then every lane
//     stores the sums of the runs that end at its pieces.  A 256-piece row
//     costs 2 rounds of dependent loads, not 256: no thread waits on more
//     than two dependent loads (record, then psum) per 128 pieces.
//     Into y (split_fixup) one lane's fold of every piece in turn would be
//     the row's whole chain (a dense row of 2,048 pieces: 16 rounds of 128
//     dependent adds), though a row's sum depends only on its runs' sums,
//     each from +0 in piece order, added in split order from +0.  So the
//     warp takes the row in super-rounds of SUPER pieces (one round at
//     RHS_CHUNK columns, where SUPER pieces would not fit a block's 48 KB
//     of static shared memory): it stages the super-round round by round,
//     each round's psum loads before the next round's records, and marks
//     the runs' starts (__ballot_sync on a change of split; at one column
//     as it goes), keeping their positions in the warp's stage; then the
//     super-round's run segments are dealt to the lanes, WARP / NB at a
//     time with a lane a segment and column, and each lane sums its
//     segment from the stage in piece order, from +0, or, for a first
//     segment that goes on with the run the previous super-round ended in,
//     from that run's sum so far: a serial sum goes on where it stopped,
//     so every bit is the same.  Every lane then adds the finished
//     segments of its column to the row sum in split order (a shuffle
//     each), and keeps the super-round's last segment as the run that may
//     go on; the row's last run is added at its end and the row stored
//     once.  The adds a row waits on in turn are its longest segment a
//     super-round, not its pieces; what stays serial is the staging, a
//     round of dependent loads and four warp votes a 128 pieces.
// Each piece is added exactly once, in piece order, starting from 0 for
// each (row, split): the in-order sum seg_fixup_plain takes with
// index_add_, bitwise (split_fixup: then the runs in order from 0, as
// split_fixup_plain adds them).  Padded piece rows [0, 1, 0, 0, 0]
// (lo > hi) add nothing.  Record loads feed up to RHS_CHUNK columns, as in
// seg_psum.
//
// seg_piece_sums: the seg family's running sums stay out of device memory.
// seg_psum writes 4 bytes a stored element (320 MB a call on an 80 M-nnz
// matrix; 8x that at B = 8) of which the fix-up reads two a piece back.
// This kernel walks a chunk as seg_psum does (a warp a chunk, the same
// loads, gathers and scan_step) and stores one float a piece and column,
// its difference.  The chunk's pieces are the contiguous range
// chunk_ptr[c] .. chunk_ptr[c+1] of the shard's row-ordered table (row
// order is chunk order in a seg shard); a chunk without pieces (padding)
// loads and stores nothing.  What bounds it on the H100: not the 8 bytes
// of vals + cols an element but the x gathers, and at B = 8 the columns'
// scans and walks.  With x batch-major, 8 columns were 8 scattered 4-byte
// gathers an element, and the B = 8 scan took 8.6x its B = 1 time on
// audikw_1; with x batch-minor an element's 8 columns are one sector, and
// seg_psum takes 2.5x (powerlaw_tail, 131k rows) to 3.1x (api/split64)
// its B = 1 time at B = 8.  On audikw_1 seg_piece_sums now takes 1,530 us
// a call at B = 8 against 314 at B = 1 (4.9x; with every column index 0,
// all gathers one row, still 1.18 of 1.55 ms): 8 columns' scans and
// window walks, a scan_step and 2-3 step_sums of shuffles a column a step,
// on 16 warps an SM (128 registers, capped: SCAN_BLOCKS), where the B = 1
// scan waits on its gathers.  Its stores, which no warp waits on, cost
// little.  So the sums never touch shared memory: a stage of 2 KB a warp
// shrank the L1 that the gathers hit and made the scan 11-66% slower than
// seg_psum on a banded matrix; in registers, with psum[hi] fetched by
// shuffles, it is 11% faster there at B = 1 and level at B = 8, and up to
// 10% slower on a power-law graph, whose many short pieces cost shuffles
// of their own.  The batched scans gather ROWS_AHEAD steps' rows at a time
// and walk the window once a step for every column (the records, ends and
// ballots are the columns' own), each column's adds in the one-column
// order.
#include "common.cuh"

namespace {

constexpr int CHUNKS_PER_BLOCK = 4;     // seg_psum: warps (chunks) a block
constexpr int LONG_ROW = 2;             // pieces a lane walks alone
constexpr int LONG_LOADS = 4;           // pieces a lane loads a round of a
                                        // long row (128 a warp)
constexpr int FIXUP_WARPS = 8;          // seg_fixup: warps a block
constexpr int ROUND = LONG_LOADS * WARP;  // a long row's pieces a round
constexpr int SUPER = 512;              // split_fixup: a long row's pieces
                                        // a super-round at one column
constexpr int STEP = 4 * WARP;          // elements a warp scans per step
constexpr int STEPS_AHEAD = 4;          // steps whose loads go out at once
constexpr int GROUP = STEP * STEPS_AHEAD;  // elements a warp's loads cover
// Steps whose x rows a batched scan (NB > 1) gathers at once: NB columns
// of 4 elements a step are 4 * NB floats a lane; a one-column scan gathers
// a group's STEPS_AHEAD.  And the blocks an SM a batched scan is built for
// (its registers capped to fit them; 0: no cap, as the one-column scans).
// tools/kernel_variants.py rows times ROWS_AHEAD 1, 2, 4 by SCAN_BLOCKS 1,
// 4, 5: (1, 4) ran seg_piece_sums at B = 8 in 0.773 ms on a half-size
// audikw_1, (1, 1) 0.850, (2, 1) 1.072 (H100; seg_psum 0.711 at both
// (1, 4) and (1, 1)).
constexpr int ROWS_AHEAD = 1;
constexpr int SCAN_BLOCKS = 4;

// One group of STEPS_AHEAD steps of a chunk's elements (`src` its first,
// element q0 of the group): each lane's 16-byte loads of vals and cols,
// all of them before the first is used.  Past L: zeros (L % 4 == 0, so a
// lane's 4 elements are all in or all out).  STREAM (seg_piece_sums'
// batched scan): loads marked evict-first, as vals and cols are read once
// a call, so the x rows the columns gather stay in L2 the longer: 2% off
// that scan at B = 8 on audikw_1, where seg_psum, whose psum stores fill
// the L2 anyway, lost 0.5% (H100).
template <bool STREAM>
__device__ __forceinline__ void load_group(const float* vals, const int* cols,
                                           long long src, int q0, int L,
                                           float4 (&v)[STEPS_AHEAD],
                                           int4 (&ci)[STEPS_AHEAD]) {
  const int lane = threadIdx.x % WARP;
#pragma unroll
  for (int u = 0; u < STEPS_AHEAD; ++u) {
    const int e = q0 + u * STEP + 4 * lane;
    v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    ci[u] = make_int4(0, 0, 0, 0);
    if (e < L) {
      if constexpr (STREAM) {
        v[u] = __ldcs(reinterpret_cast<const float4*>(vals + src + e));
        ci[u] = __ldcs(reinterpret_cast<const int4*>(cols + src + e));
      } else {
        v[u] = *reinterpret_cast<const float4*>(vals + src + e);
        ci[u] = *reinterpret_cast<const int4*>(cols + src + e);
      }
    }
  }
}

// The group's gathers of a one-column scan's x (`xb`), all before the
// first scan.
__device__ __forceinline__ void gather_group(const float* xb,
                                             const int4 (&ci)[STEPS_AHEAD],
                                             int q0, int L,
                                             float4 (&xg)[STEPS_AHEAD]) {
  const int lane = threadIdx.x % WARP;
#pragma unroll
  for (int u = 0; u < STEPS_AHEAD; ++u) {
    xg[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + u * STEP + 4 * lane < L)
      xg[u] = make_float4(xb[ci[u].x], xb[ci[u].y], xb[ci[u].z], xb[ci[u].w]);
  }
}

// A batched scan's x of steps u0 .. u0+A-1 of a group, for the nb columns
// from b0
// (`xv`, as shard_x gives it): each of a lane's 4 elements reads its row of
// x (load_x_row; at B = 8 two 16-byte loads, one sector), all before the
// first scan; xg[a][b] holds column b of the 4 elements.  Past L and past
// nb: zeros.
template <int NB, int A>
__device__ __forceinline__ void gather_rows(const float* xv, int B, int nb,
                                            bool vec,
                                            const int4 (&ci)[STEPS_AHEAD],
                                            int q0, int u0, int L,
                                            float4 (&xg)[A][NB]) {
  const int lane = threadIdx.x % WARP;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int u = u0 + a;
    float r[4][NB];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < NB; ++b) r[j][b] = 0.f;
    if (q0 + u * STEP + 4 * lane < L) {
      load_x_row<NB>(x_row<NB>(xv, ci[u].x, B), nb, vec, r[0]);
      load_x_row<NB>(x_row<NB>(xv, ci[u].y, B), nb, vec, r[1]);
      load_x_row<NB>(x_row<NB>(xv, ci[u].z, B), nb, vec, r[2]);
      load_x_row<NB>(x_row<NB>(xv, ci[u].w, B), nb, vec, r[3]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      xg[a][b] = make_float4(r[0][b], r[1][b], r[2][b], r[3][b]);
  }
}

// One step's inclusive prefix sums of one column: the lane's 4 products
// added serially, a shuffle scan over the 32 lane totals, and the carry of
// the steps before (lane 31's last sum, which `carry` becomes).  The whole
// warp calls it.
__device__ __forceinline__ float4 scan_step(float4 v, float4 xg,
                                            float& carry) {
  const int lane = threadIdx.x % WARP;
  const float s0 = __fmul_rn(v.x, xg.x);
  const float s1 = __fadd_rn(s0, __fmul_rn(v.y, xg.y));
  const float s2 = __fadd_rn(s1, __fmul_rn(v.z, xg.z));
  const float s3 = __fadd_rn(s2, __fmul_rn(v.w, xg.w));
  float incl = s3;                              // scan of the lane totals
#pragma unroll
  for (int d = 1; d < WARP; d <<= 1) {
    const float t = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl = __fadd_rn(t, incl);
  }
  float excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = 0.f;
  const float base = __fadd_rn(carry, excl);
  const float4 o = make_float4(__fadd_rn(base, s0), __fadd_rn(base, s1),
                               __fadd_rn(base, s2), __fadd_rn(base, s3));
  carry = __shfl_sync(FULL_MASK, o.w, WARP - 1);
  return o;
}

template <int NB>
__global__ void __launch_bounds__(CHUNKS_PER_BLOCK* WARP,
                                  NB == 1 ? 0 : SCAN_BLOCKS)
    seg_psum_kernel(const float* __restrict__ vals,
                    const int* __restrict__ cols, const float* __restrict__ x,
                    long long x_stride, const int* __restrict__ sids,
                    int n_sids, int C, int L, int B,
                    float* __restrict__ psum) {
  static_assert(STEPS_AHEAD % ROWS_AHEAD == 0, "whole row groups a group");
  const int lane = threadIdx.x % WARP;
  const long long chunk =
      (long long)blockIdx.x * CHUNKS_PER_BLOCK + threadIdx.x / WARP;
  if (chunk >= (long long)n_sids * C) return;   // whole warps leave
  const int k = (int)(chunk / C), c = (int)(chunk % C);
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const int sid = sids ? sids[k] : k;
  const float* xv = shard_x(x, x_stride, sid, b0);
  const bool vec = x_rows_vec(x, B);
  const long long src = ((long long)sid * C + c) * L;
  const long long cs = (long long)C * L;        // psum column stride
  float* dst = psum + ((long long)k * B + b0) * cs + (long long)c * L;
  float carry[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) carry[b] = 0.f;
  for (int q0 = 0; q0 < L; q0 += GROUP) {
    // the loads of STEPS_AHEAD steps first, then their scans in order
    float4 v[STEPS_AHEAD];
    int4 ci[STEPS_AHEAD];
    load_group<false>(vals, cols, src, q0, L, v, ci);
    if constexpr (NB == 1) {      // the group's gathers, then the scans
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= nb) continue;                  // nb is warp-uniform
        float4 xg[STEPS_AHEAD];
        gather_group(xv, ci, q0, L, xg);
#pragma unroll
        for (int u = 0; u < STEPS_AHEAD; ++u) {
          const int e = q0 + u * STEP + 4 * lane;
          if (q0 + u * STEP >= L) continue;     // warp-uniform
          const float4 o = scan_step(v[u], xg[u], carry[b]);
          if (e < L) *reinterpret_cast<float4*>(dst + b * cs + e) = o;
        }
      }
    } else {                      // ROWS_AHEAD steps' rows, then each column
#pragma unroll
      for (int u0 = 0; u0 < STEPS_AHEAD; u0 += ROWS_AHEAD) {
        float4 xg[ROWS_AHEAD][NB];
        gather_rows<NB, ROWS_AHEAD>(xv, B, nb, vec, ci, q0, u0, L, xg);
#pragma unroll
        for (int a = 0; a < ROWS_AHEAD; ++a) {
          const int u = u0 + a, e = q0 + u * STEP + 4 * lane;
          if (q0 + u * STEP >= L) continue;     // warp-uniform
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if (b >= nb) continue;              // nb is warp-uniform
            const float4 o = scan_step(v[u], xg[a][b], carry[b]);
            if (e < L) *reinterpret_cast<float4*>(dst + b * cs + e) = o;
          }
        }
      }
    }
  }
}

// lo and hi of piece p of a shard's table `pc`; a slot at or past `pe` is
// the padded piece (lo > hi).
__device__ __forceinline__ int2 piece_span(const int* pc, int p, int pe) {
  if (p >= pe) return make_int2(1, 0);
  const int* rec = pc + (long long)p * 5;
  return make_int2(rec[1], rec[2]);
}

// Step sum e (0 <= e < STEP) of a step scanned into the lanes' `o`: lane
// e / 4 holds it, as component e % 4.  The whole warp calls it.
__device__ __forceinline__ float step_sum(float4 o, int e) {
  const int src = e >> 2, comp = e & 3;
  const float a = __shfl_sync(FULL_MASK, o.x, src);
  const float b = __shfl_sync(FULL_MASK, o.y, src);
  const float c = __shfl_sync(FULL_MASK, o.z, src);
  const float d = __shfl_sync(FULL_MASK, o.w, src);
  return comp == 0 ? a : comp == 1 ? b : comp == 2 ? c : d;
}

// seg_piece_sums: seg_psum's loads and scan, a warp a chunk, but the
// running sums stay in registers.  After each step's scan the warp reads
// the chunk's pieces, the range [p0, p1) of the shard's table that
// chunk_ptr gives, 32 at a time, a lane a piece: a piece whose hi lies in
// the step stores d = psum[hi] - psum[lo - 1] (psum[hi] where lo == 0; 0
// where lo > hi), piece_diff's one subtraction on seg_psum's sums.
// psum[hi] comes from the lane that holds it (step_sum); psum[lo - 1] is
// the previous piece's psum[hi] where that piece ends at lo - 1 in the
// step, as pieces tile a chunk (one shuffle up), else it is fetched, or,
// where it lies in an earlier step, kept in `pend`: pieces of a chunk are
// disjoint and in position order, so at most one runs on past a step.  A
// window holding such a piece is read again at the next step.  A padded
// piece stores 0 whenever its window is read.
template <int NB>
__global__ void __launch_bounds__(CHUNKS_PER_BLOCK* WARP,
                                  NB == 1 ? 0 : SCAN_BLOCKS)
    seg_piece_sums_kernel(const float* __restrict__ vals,
                          const int* __restrict__ cols,
                          const float* __restrict__ x, long long x_stride,
                          const int* __restrict__ pieces,
                          const int* __restrict__ chunk_ptr,
                          const int* __restrict__ sids, int n_sids, int C,
                          int L, int Pp, int B, float* __restrict__ d) {
  const int lane = threadIdx.x % WARP;
  const long long chunk =
      (long long)blockIdx.x * CHUNKS_PER_BLOCK + threadIdx.x / WARP;
  if (chunk >= (long long)n_sids * C) return;   // whole warps leave
  const int k = (int)(chunk / C), c = (int)(chunk % C);
  const int sid = sids[k];
  const int* cp = chunk_ptr + (long long)sid * (C + 1) + c;
  const int p0 = cp[0], p1 = cp[1];
  if (p0 >= p1) return;                         // no pieces: nothing to store
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const float* xv = shard_x(x, x_stride, sid, b0);
  const bool vec = x_rows_vec(x, B);
  const long long src = ((long long)sid * C + c) * L;
  const int* pc = pieces + (long long)sid * Pp * 5;
  float* dk = d + ((long long)k * B + b0) * Pp;  // column b0's pieces
  float carry[NB], pend[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) carry[b] = pend[b] = 0.f;
  int w0 = p0;                                  // the first unfinished window
  int2 first = piece_span(pc, w0 + lane, p1);   // its pieces, loaded ahead
  for (int q0 = 0; q0 < L; q0 += GROUP) {
    float4 v[STEPS_AHEAD];
    int4 ci[STEPS_AHEAD];
    load_group<(NB > 1)>(vals, cols, src, q0, L, v, ci);
    int done = 0;                   // windows from w0 the group finished
    if constexpr (NB == 1) {        // the group's gathers, then the steps
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= nb) continue;                    // nb is warp-uniform
        float4 xg[STEPS_AHEAD];
        gather_group(xv, ci, q0, L, xg);
        float* db = dk + (long long)b * Pp;
        int i0 = 0;                   // this column's first unfinished window
#pragma unroll
        for (int u = 0; u < STEPS_AHEAD; ++u) {
          const int q = q0 + u * STEP, qe = q + STEP;
          if (q >= L) continue;                   // warp-uniform
          const float4 o = scan_step(v[u], xg[u], carry[b]);
          // the piece before a window's lane 0: lane 31 of the window before,
          // when that window was read in this step (else unknown: -2)
          float h_in = 0.f;
          int hi_in = -2;
          for (int i = i0; w0 + i * WARP < p1; ++i) {
            const int p = w0 + i * WARP + lane;
            const int2 s = i == 0 ? first : piece_span(pc, p, p1);
            const int lo = s.x, hi = s.y;
            const bool real = p < p1 && lo <= hi;
            const bool ends = real && hi >= q && hi < qe;
            float h = 0.f;
            if (__any_sync(FULL_MASK, ends))
              h = step_sum(o, ends ? hi - q : 0);
            // psum[lo - 1] is the previous piece's psum[hi] where that piece
            // ends at lo - 1 in this step (pieces tile a chunk); else it is
            // fetched, or `pend` where it lies in an earlier step
            float h_prev = __shfl_up_sync(FULL_MASK, h, 1);
            int hi_prev = __shfl_up_sync(FULL_MASK, real ? hi : -2, 1);
            if (lane == 0) {
              h_prev = h_in;
              hi_prev = hi_in;
            }
            const bool at_here = real && lo > 0 && lo - 1 >= q && lo - 1 < qe;
            const bool adj = hi_prev == lo - 1;
            float before = at_here ? h_prev : pend[b];
            if (__any_sync(FULL_MASK, at_here && !adj)) {
              const float t = step_sum(o, at_here && !adj ? lo - 1 - q : 0);
              if (at_here && !adj) before = t;
            }
            if (ends)
              db[p] = lo == 0 ? h : __fsub_rn(h, before);
            else if (p < p1 && !real)
              db[p] = 0.f;
            // a piece that runs on past the step: keep its sum at lo - 1 if
            // that lies here, and read this window again at the next step
            const bool on = real && hi >= qe;
            const unsigned keep = __ballot_sync(FULL_MASK, on && at_here);
            if (keep) pend[b] = __shfl_sync(FULL_MASK, before, __ffs(keep) - 1);
            i0 = i;
            if (__any_sync(FULL_MASK, on)) break;
            i0 = i + 1;
            h_in = __shfl_sync(FULL_MASK, h, WARP - 1);
            hi_in = __shfl_sync(FULL_MASK, real ? hi : -2, WARP - 1);
          }
        }
        done = i0;
      }
    } else {                        // ROWS_AHEAD steps' rows at a time
      int i0 = 0;                   // the first window from w0 not finished
#pragma unroll
      for (int u0 = 0; u0 < STEPS_AHEAD; u0 += ROWS_AHEAD) {
        float4 xg[ROWS_AHEAD][NB];
        gather_rows<NB, ROWS_AHEAD>(xv, B, nb, vec, ci, q0, u0, L, xg);
#pragma unroll
        for (int a = 0; a < ROWS_AHEAD; ++a) {
          const int u = u0 + a;
          const int q = q0 + u * STEP, qe = q + STEP;
          if (q >= L) continue;                 // warp-uniform
          float4 o[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (b < nb) o[b] = scan_step(v[u], xg[a][b], carry[b]);
          // the piece before a window's lane 0: lane 31 of the window
          // before, when that window was read in this step (else -2)
          float h_in[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) h_in[b] = 0.f;
          int hi_in = -2;
          for (int i = i0; w0 + i * WARP < p1; ++i) {
            // the window's records, ends and carries serve every column
            const int p = w0 + i * WARP + lane;
            const int2 s = i == 0 ? first : piece_span(pc, p, p1);
            const int lo = s.x, hi = s.y;
            const bool real = p < p1 && lo <= hi;
            const bool ends = real && hi >= q && hi < qe;
            const bool any_ends = __any_sync(FULL_MASK, ends);
            int hi_prev = __shfl_up_sync(FULL_MASK, real ? hi : -2, 1);
            if (lane == 0) hi_prev = hi_in;
            // psum[lo - 1]: the previous piece's psum[hi] where that piece
            // ends at lo - 1 in this step, else fetched, or `pend`
            const bool at_here =
                real && lo > 0 && lo - 1 >= q && lo - 1 < qe;
            const bool fetch = at_here && hi_prev != lo - 1;
            const bool any_fetch = __any_sync(FULL_MASK, fetch);
            // a piece that runs on past the step keeps its sum at lo - 1
            const bool on = real && hi >= qe;
            const unsigned keep = __ballot_sync(FULL_MASK, on && at_here);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              if (b >= nb) continue;            // nb is warp-uniform
              float h = 0.f;
              if (any_ends) h = step_sum(o[b], ends ? hi - q : 0);
              float h_prev = __shfl_up_sync(FULL_MASK, h, 1);
              if (lane == 0) h_prev = h_in[b];
              float before = at_here ? h_prev : pend[b];
              if (any_fetch) {
                const float t = step_sum(o[b], fetch ? lo - 1 - q : 0);
                if (fetch) before = t;
              }
              float* db = dk + (long long)b * Pp;
              if (ends)
                db[p] = lo == 0 ? h : __fsub_rn(h, before);
              else if (p < p1 && !real)
                db[p] = 0.f;
              if (keep)
                pend[b] = __shfl_sync(FULL_MASK, before, __ffs(keep) - 1);
              h_in[b] = __shfl_sync(FULL_MASK, h, WARP - 1);
            }
            i0 = i;
            if (__any_sync(FULL_MASK, on)) break;
            i0 = i + 1;
            hi_in = __shfl_sync(FULL_MASK, real ? hi : -2, WARP - 1);
          }
        }
      }
      done = i0;
    }
    if (done > 0) {
      w0 += done * WARP;
      first = piece_span(pc, w0 + lane, p1);
    }
  }
}

// The prefix difference of one piece on one column's psum row `ps`
// (chunk already applied); a padded piece (lo > hi) gives 0, which
// leaves any running sum unchanged (the sums start at +0 and so are
// never -0).
__device__ __forceinline__ float piece_diff(const float* ps, int lo, int hi) {
  if (lo > hi) return 0.f;
  const float h = ps[hi];
  return lo > 0 ? __fsub_rn(h, ps[lo - 1]) : h;
}

// Split t's sums of one row for the nb columns; `o` points at the row's
// output of column 0, split 0.
template <int NB>
__device__ __forceinline__ void store_run(float* o, int NS, int R, int t,
                                          int nb, const float (&v)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b < nb) o[((long long)b * NS + t) * R] = v[b];
  }
}

// A round of a long row's records: lane i holds pieces base + 32u + i; a
// slot past the row is the padded piece (lo > hi), which adds nothing.
struct Records {
  int ch[LONG_LOADS], lo[LONG_LOADS], hi[LONG_LOADS], split[LONG_LOADS];
};

__device__ __forceinline__ void load_records(const int* pc, int base, int pe,
                                             int NS, Records& rc) {
  const int lane = threadIdx.x % WARP;
#pragma unroll
  for (int u = 0; u < LONG_LOADS; ++u) {
    const int p = base + u * WARP + lane;
    const bool real = p < pe;
    const int* rec = pc + (long long)p * 5;
    rc.ch[u] = real ? rec[0] : 0;
    rc.lo[u] = real ? rec[1] : 1;
    rc.hi[u] = real ? rec[2] : 0;
    rc.split[u] = real && NS > 1 ? rec[4] : 0;
  }
}

// The whole warp takes one long row's pieces [p, pe) a round at a time.
// Each round's splits and differences go to the warp's stage in shared
// memory (`sd` a row of SP + 4 floats a column, so the folding lanes'
// 16-byte reads hit distinct banks; a round fills its first ROUND), the
// next round's records go out, and lane b < nb adds column b's differences
// in piece order, 4 a shared-memory read, leaving each piece's running sum
// in the stage; then every lane stores the sums of the runs that end in
// its pieces.  `o` points at the row's output of column 0, split 0.  With
// DIFFS (NS = 1) the differences are read from seg_piece_sums' d (`ps` the
// shard's column b0, piece p at ps[p]): no records, one coalesced load a
// round.
template <int NB, bool DIFFS, int SP>
__device__ __forceinline__ void long_row_fixup(
    const float* ps, long long cs, const int* pc, int p, int pe, int L,
    int NS, int R, int nb, float* o, float (&sd)[NB][SP + 4],
    int (&ss)[SP]) {
  const int lane = threadIdx.x % WARP;
  Records rc;
  if constexpr (!DIFFS) load_records(pc, p, pe, NS, rc);
  float acc = 0.f;                              // lane b: column b's sum
  int t = -1;                                   // the split being summed
  for (int base = p; base < pe; base += ROUND) {
#pragma unroll
    for (int u = 0; u < LONG_LOADS; ++u) {
      const int i = u * WARP + lane;
      if constexpr (DIFFS) {
        ss[i] = 0;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          sd[b][i] = b < nb && base + i < pe ? ps[b * cs + base + i] : 0.f;
      } else {
        ss[i] = rc.split[u];
#pragma unroll
        for (int b = 0; b < NB; ++b)
          sd[b][i] = b < nb ? piece_diff(ps + b * cs +
                                             (long long)rc.ch[u] * L,
                                         rc.lo[u], rc.hi[u])
                            : 0.f;
      }
    }
    if constexpr (!DIFFS)
      load_records(pc, base + ROUND, pe, NS, rc);   // the next round's
    __syncwarp();
    const int cnt = min(ROUND, pe - base);
    if (lane < nb) {
#pragma unroll 2
      for (int i0 = 0; i0 < cnt; i0 += 4) {
        const int4 t4 = *reinterpret_cast<const int4*>(&ss[i0]);
        float4 d4 = *reinterpret_cast<const float4*>(&sd[lane][i0]);
        const int ts[4] = {t4.x, t4.y, t4.z, t4.w};
        float ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i0 + j < cnt) {
            acc = ts[j] != t ? 0.f : acc;       // a new run starts from 0
            acc = __fadd_rn(acc, ds[j]);
            t = ts[j];
            ds[j] = acc;
          }
        }
        *reinterpret_cast<float4*>(&sd[lane][i0]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    }
    __syncwarp();
    // piece i ends a run where the next piece has another split or the row
    // ends; the next round's first split is lane 0's first record
    int next_split = 0;
    if constexpr (!DIFFS) next_split = __shfl_sync(FULL_MASK, rc.split[0], 0);
#pragma unroll
    for (int u = 0; u < LONG_LOADS; ++u) {
      const int i = u * WARP + lane;
      if (i < cnt) {
        const int after = i + 1 < cnt ? ss[i + 1]
                          : base + ROUND < pe ? next_split : -1;
        if (after != ss[i]) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (b < nb) o[((long long)b * NS + ss[i]) * R] = sd[b][i];
        }
      }
    }
    __syncwarp();                 // the stage is read before it is refilled
  }
}

// The in-order sum of d[i .. e - 1] onto `acc`, four a 16-byte read (`d`
// 16-byte aligned).
__device__ __forceinline__ float sum_run(const float* d, int i, int e,
                                         float acc) {
  for (; i < e && (i & 3); ++i) acc = __fadd_rn(acc, d[i]);
#pragma unroll 2
  for (; i + 4 <= e; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(d + i);
    acc = __fadd_rn(acc, v.x);
    acc = __fadd_rn(acc, v.y);
    acc = __fadd_rn(acc, v.z);
    acc = __fadd_rn(acc, v.w);
  }
  for (; i < e; ++i) acc = __fadd_rn(acc, d[i]);
  return acc;
}

// Stage pieces [q, q + cnt) of a long row at one column, a round at a
// time: `rc` holds the first round's records on entry and those of the
// round after the last on return.  A round's psum loads go out, then the
// next round's records, then its differences go to `d` as they land and
// its run starts are found window by window (a shuffle and a ballot
// each): a piece starts a segment where its split differs from the piece
// before (lane l - 1's, or for lane 0 lane 31's of the window before), and
// piece 0 always does; each segment's first position goes to `seg`, in
// piece order.  Returns the segments' count; `first` and `last` get the
// splits of pieces 0 and cnt - 1, read from the table.
template <int SP>
__device__ __forceinline__ int stage_column(const float* ps, const int* pc,
                                            int q, int cnt, int pe, int L,
                                            int NS, float* d, int (&seg)[SP],
                                            Records& rc, int& first,
                                            int& last) {
  const int lane = threadIdx.x % WARP;
  int nseg = 0;
  int tail = 0;                   // lane 31: the split ending the last round
  for (int r0 = 0; r0 < cnt; r0 += ROUND) {
    int sp[LONG_LOADS];
    float dv[LONG_LOADS];
#pragma unroll
    for (int u = 0; u < LONG_LOADS; ++u) {
      sp[u] = rc.split[u];
      dv[u] = piece_diff(ps + (long long)rc.ch[u] * L, rc.lo[u], rc.hi[u]);
    }
    load_records(pc, q + r0 + ROUND, pe, NS, rc);   // the next round's
#pragma unroll
    for (int u = 0; u < LONG_LOADS; ++u) {
      const int i = r0 + u * WARP + lane;
      d[i] = dv[u];
      const int give =
          lane < WARP - 1 ? sp[u] : u == 0 ? tail : sp[u > 0 ? u - 1 : 0];
      const int before = __shfl_sync(FULL_MASK, give, (lane + 31) % 32);
      const unsigned m =
          __ballot_sync(FULL_MASK, i < cnt && (i == 0 || sp[u] != before));
      if (m >> lane & 1) seg[nseg + __popc(m & ((1u << lane) - 1))] = i;
      nseg += __popc(m);
    }
    tail = sp[LONG_LOADS - 1];
  }
  first = NS > 1 ? pc[(long long)q * 5 + 4] : 0;
  last = NS > 1 ? pc[(long long)(q + cnt - 1) * 5 + 4] : 0;
  return nseg;
}

// split_fixup's long rows (`fold`): the whole warp takes the row's pieces
// [p, pe) a super-round of SP at a time, staging its differences in `sd`
// (a row of SP + 4 floats a column) and, in piece order, the first
// position of each run segment in `seg`: a piece starts one where its
// split differs from the piece before, and piece 0 always does.  At one
// column the run starts are found as each round is staged (stage_column);
// at NB > 1 a round is staged as long_row_fixup stages it (its splits in
// `seg`, then the next round's records), so the NB columns' loads take
// the registers they take there, and the starts are found from the staged
// splits afterwards, compacted into `seg` in place.  Then lane (slot, b)
// sums column b of segments w0 + slot, SLOTS = WARP / NB at a time, in
// piece order (four a 16-byte read) from +0, or, for segment 0 where it
// goes on with the run the super-round before ended in (its split is
// `t`), from that run's sum so far (`carry`); and every lane adds its
// column's finished segments to the row sum, in order, by shuffles,
// keeping the super-round's last segment as `carry`.  A run that ended
// with the super-round before is added before segment 0.  So each run is
// its pieces' in-order sum from +0 and the row its runs' sum in split
// order from +0, as split_fixup_plain adds them, bit for bit.  `o` points
// at the row's y of column 0 (a column R floats apart); it is stored once,
// at the row's end.
template <int NB, int SP>
__device__ __forceinline__ void long_row_fold(
    const float* ps, long long cs, const int* pc, int p, int pe, int L,
    int NS, int R, int nb, float* o, float (&sd)[NB][SP + 4],
    int (&seg)[SP]) {
  static_assert(SP % ROUND == 0, "whole rounds a super-round");
  constexpr int SLOTS = WARP / NB;              // segments summed at once
  const int lane = threadIdx.x % WARP;
  const int slot = lane / NB, b = lane % NB;
  Records rc;
  load_records(pc, p, pe, NS, rc);
  float row = 0.f;                // column b's finished runs
  float carry = 0.f;              // the run the last super-round ended in
  int t = -1;                     // its split
  for (int base = p; base < pe; base += SP) {
    const int cnt = min(SP, pe - base);
    int nseg = 0;                 // segments of the super-round
    int first = 0, last = 0;      // the splits of its first and last piece
    if constexpr (NB == 1) {
      nseg = stage_column<SP>(ps, pc, base, cnt, pe, L, NS, sd[0], seg, rc,
                              first, last);
    } else {
      for (int r0 = 0; r0 < cnt; r0 += ROUND) {
#pragma unroll
        for (int u = 0; u < LONG_LOADS; ++u) {
          const int i = r0 + u * WARP + lane;
          seg[i] = rc.split[u];
#pragma unroll
          for (int c = 0; c < NB; ++c)
            sd[c][i] = c < nb ? piece_diff(ps + c * cs +
                                               (long long)rc.ch[u] * L,
                                           rc.lo[u], rc.hi[u])
                              : 0.f;
        }
        load_records(pc, base + r0 + ROUND, pe, NS, rc);  // the next round's
      }
    }
    __syncwarp();                 // the stage is written before it is read
    if constexpr (NB > 1) {       // the run starts, from the staged splits
      int tail = 0;               // the split ending the window before
      first = seg[0];
      last = seg[cnt - 1];
      for (int w = 0; w < cnt; w += WARP) {
        const int i = w + lane;
        const int s = i < cnt ? seg[i] : 0;
        int before = __shfl_up_sync(FULL_MASK, s, 1);
        if (lane == 0) before = tail;
        const unsigned m =
            __ballot_sync(FULL_MASK, i < cnt && (i == 0 || s != before));
        tail = __shfl_sync(FULL_MASK, s, WARP - 1);
        __syncwarp();             // the window is read before it is written
        if (m >> lane & 1) seg[nseg + __popc(m & ((1u << lane) - 1))] = i;
        nseg += __popc(m);
      }
      __syncwarp();
    }
    const bool cont = first == t;               // segment 0 goes on with it
    if (!cont) row = __fadd_rn(row, carry);     // +0 at the row's start
    for (int w0 = 0; w0 < nseg; w0 += SLOTS) {
      const int k = w0 + slot;
      float acc = k == 0 && cont ? carry : 0.f;
      if (k < nseg && b < nb)
        acc = sum_run(sd[b], seg[k], k + 1 < nseg ? seg[k + 1] : cnt, acc);
      const int n = min(SLOTS, nseg - w0);
      for (int j = 0; j < n; ++j) {
        const float v = __shfl_sync(FULL_MASK, acc, j * NB + b);
        if (w0 + j < nseg - 1)
          row = __fadd_rn(row, v);
        else
          carry = v;                            // it may go on
      }
    }
    t = last;
    __syncwarp();                 // the stage is read before it is refilled
  }
  if (slot == 0 && b < nb) o[(long long)b * R] = __fadd_rn(row, carry);
}

// Row r of the k-th launched shard: its piece table (null without one),
// psum or d of column b0 and output of column b0, split 0.
struct FixupRow {
  const float* ps;
  const int* pc;
  const int* ptr;
  float* o;
};

__device__ __forceinline__ FixupRow fixup_row(
    const float* psum, const int* pieces, const int* piece_ptr,
    const int* sids, const int* out_ids, float* out, int k, int r,
    long long cs, int Pp, int R, int NS, int B, int b0) {
  const int sid = sids[k];
  return {psum + ((long long)k * B + b0) * cs,
          pieces ? pieces + (long long)sid * Pp * 5 : nullptr,
          piece_ptr + (long long)sid * (R + 1),
          out + ((long long)out_ids[k] * B + b0) * NS * R + r};
}

// One column: at least 4 blocks an SM, so that the short rows' chain of
// three dependent loads (piece_ptr, record, psum) has the warps to hide it
// (left free, ptxas takes 66-68 registers a thread: 3 blocks an SM).
// RHS_CHUNK columns over psum: at least 3, the 80 registers a thread the
// fix-up took before split_fixup's super-rounds (with them, left free,
// 87-121: 2 blocks an SM, and the short rows 25% slower at B = 8).
// DIFFS: `src` is seg_piece_sums' d (n, B, Pp) and NS = 1, so a piece's
// difference is one load at its index, the chain two loads (piece_ptr,
// d) and `pieces`, C and L are not read; else `src` is psum (n, B, C, L).
// `to_y` (read only without DIFFS): `out` is y (S, B, R) at out_ids[k],
// one value a row and column, its runs' sum; else the NS-split output.
template <int NB, bool DIFFS>
__global__ void __launch_bounds__(FIXUP_WARPS* WARP,
                                  NB == 1 ? 4 : DIFFS ? 1 : 3)
    seg_fixup_kernel(const float* __restrict__ src,
                     const int* __restrict__ pieces,
                     const int* __restrict__ piece_ptr,
                     const int* __restrict__ sids,
                     const int* __restrict__ out_ids, int n_sids, int C,
                     int L, int Pp, int R, int NS, int B,
                     float* __restrict__ out, bool to_y) {
  // a long row's round (or, under `fold`, super-round) a warp: its
  // differences, and its splits (the run segments' starts under `fold`).
  // A super-round is SUPER pieces at one column and a round at RHS_CHUNK,
  // where SUPER pieces of NB floats would not fit a block's 48 KB of
  // static shared memory.
  constexpr int SP = DIFFS || NB > 1 ? ROUND : SUPER;
  __shared__ unsigned long_rows[FIXUP_WARPS];   // each warp's, a bit a lane
  __shared__ __align__(16) float stage_d[FIXUP_WARPS][NB][SP + 4];
  __shared__ __align__(16) int stage_s[FIXUP_WARPS][SP];
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int wps = (R + WARP - 1) / WARP;        // warps a shard
  const long long warps = (long long)n_sids * wps;
  const long long w = (long long)blockIdx.x * FIXUP_WARPS + warp;
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const long long cs = DIFFS ? (long long)Pp : (long long)C * L;  // column
                                                                    // stride
  const bool fold = !DIFFS && to_y;   // false at compile time under DIFFS
  const int ons = fold ? 1 : NS;                // splits of the output
  bool long_row = false;
  if (w < warps) {                              // idle warps still meet
    const int k = (int)(w / wps);               // the barrier below
    const int r = (int)(w % wps) * WARP + lane;
    const bool live = r < R;
    const FixupRow row = fixup_row(src, pieces, piece_ptr, sids, out_ids,
                                   out, k, r, cs, Pp, R, ons, B, b0);
    const int p = live ? row.ptr[r] : 0;
    const int pe = live ? row.ptr[r + 1] : 0;
    long_row = pe - p > LONG_ROW;
    const int m = long_row ? 0 : pe - p;        // pieces this lane walks

    // -- short rows: records, then psum pairs (or the d of DIFFS), then
    // the in-order sums -----------------------------------------------------
    int sp[LONG_ROW];
    float run[LONG_ROW][NB];                    // running sum at piece j
    if constexpr (DIFFS) {
#pragma unroll
      for (int j = 0; j < LONG_ROW; ++j) {
        sp[j] = 0;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          run[j][b] = j < m && b < nb ? row.ps[b * cs + p + j] : 0.f;
      }
    } else {
      int ch[LONG_ROW], lo[LONG_ROW], hi[LONG_ROW];
#pragma unroll
      for (int j = 0; j < LONG_ROW; ++j) {
        const int* rec = row.pc + (long long)(p + j) * 5;
        const bool real = j < m;
        ch[j] = real ? rec[0] : 0;
        lo[j] = real ? rec[1] : 1;
        hi[j] = real ? rec[2] : 0;
        sp[j] = real && NS > 1 ? rec[4] : 0;
      }
#pragma unroll
      for (int j = 0; j < LONG_ROW; ++j) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          run[j][b] = b < nb ? piece_diff(row.ps + b * cs +
                                              (long long)ch[j] * L,
                                          lo[j], hi[j])
                             : 0.f;
      }
    }
    float acc[NB], sum[NB];                     // sum: fold's finished runs
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = sum[b] = 0.f;
    int t_last = -1;
#pragma unroll
    for (int j = 0; j < LONG_ROW; ++j) {
      if (j < m) {
        if (j > 0 && sp[j] != sp[j - 1]) {
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if (fold) sum[b] = __fadd_rn(sum[b], acc[b]);
            acc[b] = 0.f;
          }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          acc[b] = __fadd_rn(acc[b], run[j][b]);
          run[j][b] = acc[b];
        }
        t_last = sp[j];
      }
    }
    if (fold) {                 // the last run, then one store; long: below
      if (live && !long_row) {
#pragma unroll
        for (int b = 0; b < NB; ++b) sum[b] = __fadd_rn(sum[b], acc[b]);
        store_run<NB>(row.o, 1, R, 0, nb, sum);
      }
    } else if (live && NS == 1) {
      if (!long_row) store_run<NB>(row.o, 1, R, 0, nb, acc);  // long: below
    } else if (live) {          // every split of the row; a long row's 0s
      const int t_first = m ? sp[0] : NS;
      for (int t = 0; t < NS; ++t) {
        float v[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) v[b] = 0.f;
        if (t >= t_first && t <= t_last) {      // the run's last sum wins
#pragma unroll
          for (int j = 0; j < LONG_ROW; ++j) {
            if (j < m && sp[j] == t) {
#pragma unroll
              for (int b = 0; b < NB; ++b) v[b] = run[j][b];
            }
          }
        }
        store_run<NB>(row.o, NS, R, t, nb, v);
      }
    }
  }

  // -- long rows: the block's, dealt out to its warps in turn -------------
  const unsigned mine = __ballot_sync(FULL_MASK, long_row);
  if (lane == 0) long_rows[warp] = mine;
  __syncthreads();         // a long row's zero stores land before its sums
                           // (into partials; into y its lane stores none)
  int rank = 0;
  for (int v = 0; v < FIXUP_WARPS; ++v) {
    for (unsigned mask = long_rows[v]; mask; mask &= mask - 1) {
      if (rank++ % FIXUP_WARPS != warp) continue;
      const long long wv = (long long)blockIdx.x * FIXUP_WARPS + v;
      const int k = (int)(wv / wps);
      const int r = (int)(wv % wps) * WARP + __ffs(mask) - 1;
      const FixupRow row = fixup_row(src, pieces, piece_ptr, sids, out_ids,
                                     out, k, r, cs, Pp, R, ons, B, b0);
      if constexpr (!DIFFS) {
        if (fold) {
          long_row_fold<NB, SP>(row.ps, cs, row.pc, row.ptr[r],
                                row.ptr[r + 1], L, NS, R, nb, row.o,
                                stage_d[warp], stage_s[warp]);
          continue;
        }
      }
      long_row_fixup<NB, DIFFS, SP>(row.ps, cs, row.pc, row.ptr[r],
                                    row.ptr[r + 1], L, NS, R, nb, row.o,
                                    stage_d[warp], stage_s[warp]);
    }
  }
}

}  // namespace

int launch_seg_psum(const float* vals, const int* cols, const float* x,
                    long long x_stride, const int* sids, int n_sids, int C,
                    int L, int B, float* psum, cudaStream_t s) {
  const long long chunks = (long long)n_sids * C;
  if (chunks == 0 || B == 0) return 0;
  const unsigned blocks =
      (unsigned)((chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK);
  constexpr int threads = CHUNKS_PER_BLOCK * WARP;
  if (B == 1)
    seg_psum_kernel<1><<<blocks, threads, 0, s>>>(vals, cols, x, x_stride,
                                                  sids, n_sids, C, L, B,
                                                  psum);
  else
    seg_psum_kernel<RHS_CHUNK>
        <<<dim3(blocks, (B + RHS_CHUNK - 1) / RHS_CHUNK), threads, 0, s>>>(
            vals, cols, x, x_stride, sids, n_sids, C, L, B, psum);
  return (int)cudaGetLastError();
}

RT_API int rt_seg_psum(const float* vals, const int* cols, const float* x,
                       long long x_stride, const int* sids, int n_sids, int C,
                       int L, int B, float* psum, void* stream) {
  return launch_seg_psum(vals, cols, x, x_stride, sids, n_sids, C, L, B,
                         psum, (cudaStream_t)stream);
}

namespace {

// Both fix-ups' launch: a warp per 32 rows of a shard, FIXUP_WARPS warps a
// block, RHS_CHUNK columns a grid.y.
template <bool DIFFS>
int launch_fixup(const float* src, const int* pieces, const int* piece_ptr,
                 const int* sids, const int* out_ids, int n_sids, int C,
                 int L, int Pp, int R, int NS, int B, float* out, bool to_y,
                 cudaStream_t s) {
  const long long warps = (long long)n_sids * ((R + WARP - 1) / WARP);
  if (warps == 0 || B == 0) return 0;
  const unsigned blocks = (unsigned)((warps + FIXUP_WARPS - 1) / FIXUP_WARPS);
  constexpr int threads = FIXUP_WARPS * WARP;
  if (B == 1)
    seg_fixup_kernel<1, DIFFS><<<blocks, threads, 0, s>>>(
        src, pieces, piece_ptr, sids, out_ids, n_sids, C, L, Pp, R, NS, B,
        out, to_y);
  else
    seg_fixup_kernel<RHS_CHUNK, DIFFS>
        <<<dim3(blocks, (B + RHS_CHUNK - 1) / RHS_CHUNK), threads, 0, s>>>(
            src, pieces, piece_ptr, sids, out_ids, n_sids, C, L, Pp, R, NS,
            B, out, to_y);
  return (int)cudaGetLastError();
}

}  // namespace

RT_API int rt_seg_fixup(const float* psum, const int* pieces,
                        const int* piece_ptr, const int* sids,
                        const int* out_ids, int n_sids, int C, int L, int Pp,
                        int R, int NS, int B, float* out, void* stream) {
  return launch_fixup<false>(psum, pieces, piece_ptr, sids, out_ids, n_sids,
                             C, L, Pp, R, NS, B, out, false,
                             (cudaStream_t)stream);
}

// The split family's fix-up and combine in one launch: seg_fixup_kernel
// over psum with `to_y`, each row's runs summed in split order straight
// into y (S, B, R) at the launched shards' own rows.
RT_API int rt_split_fixup(const float* psum, const int* pieces,
                          const int* piece_ptr, const int* sids, int n_sids,
                          int C, int L, int Pp, int R, int NS, int B,
                          float* out, void* stream) {
  return launch_fixup<false>(psum, pieces, piece_ptr, sids, sids, n_sids, C,
                             L, Pp, R, NS, B, out, true,
                             (cudaStream_t)stream);
}

RT_API int rt_seg_piece_sums(const float* vals, const int* cols,
                             const float* x, long long x_stride,
                             const int* pieces, const int* chunk_ptr,
                             const int* sids, int n_sids, int C, int L,
                             int Pp, int B, float* d, void* stream) {
  const long long chunks = (long long)n_sids * C;
  if (chunks == 0 || B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks =
      (unsigned)((chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK);
  constexpr int threads = CHUNKS_PER_BLOCK * WARP;
  if (B == 1)
    seg_piece_sums_kernel<1><<<blocks, threads, 0, s>>>(
        vals, cols, x, x_stride, pieces, chunk_ptr, sids, n_sids, C, L, Pp,
        B, d);
  else
    seg_piece_sums_kernel<RHS_CHUNK>
        <<<dim3(blocks, (B + RHS_CHUNK - 1) / RHS_CHUNK), threads, 0, s>>>(
            vals, cols, x, x_stride, pieces, chunk_ptr, sids, n_sids, C, L,
            Pp, B, d);
  return (int)cudaGetLastError();
}

// The seg family's fix-up: seg_fixup_kernel over seg_piece_sums' d, NS = 1,
// straight into y (S, B, R) at the launched shards' own rows.
RT_API int rt_seg_piece_fixup(const float* d, const int* piece_ptr,
                              const int* sids, int n_sids, int Pp, int R,
                              int B, float* out, void* stream) {
  return launch_fixup<true>(d, nullptr, piece_ptr, sids, sids, n_sids, 0, 0,
                            Pp, R, 1, B, out, false, (cudaStream_t)stream);
}
