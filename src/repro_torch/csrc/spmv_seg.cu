// Nonzero-balanced segmented SpMV: per-chunk prefix sums + carry fix-up.
//
// Replaces: src/repro/kernels/spmv_seg.py seg_psum (_seg_kernel,
// pallas_call at :56), and the jnp carry fix-ups that followed it on the
// device path (src/repro/kernels/ops.py _seg_fixup :158 and
// _split_flat_fixup :275, which are jnp glue, not TPU kernels).
//
// seg_psum:  psum[k, b, c, l] = sum_{j <= l} vals[s, c, j] * x[s, b, cols[s, c, j]]
// seg_fixup: out[o, b, t, r] = sum over r's pieces of split t of
//            psum[k, b, chunk, hi] - psum[k, b, chunk, lo - 1]
//
// What bounds them on the H100: bytes.  The scan reads 8 bytes of
// vals + cols and gathers 4 bytes of x per element and writes the 4-byte
// prefix sum; the fix-up reads two psum values per piece.  The TPU kernel
// scanned a whole (8, 512) tile per grid step in VMEM; a Hopper block has
// no sequential grid to carry state in, so each chunk is one independent
// block and the cross-chunk carry is the fix-up's job.
//
// Design: seg_psum runs one block of L threads per (chunk, column b):
// each thread forms one product, and block_inclusive_scan (common.cuh,
// shared with split_psum) takes a warp scan with shuffles inside each
// warp, then one pass of warp 0 over the warp totals (in shared memory)
// adds the carry between warps.  The order is fixed, so the result is
// deterministic.  seg_fixup runs one
// thread per output (row r, split t): the row's pieces are a contiguous
// run of the row-ordered piece table (range from the host table
// piece_ptr, (S, R+1), built with searchsorted over the shard's real
// pieces), split-ordered within the row, so a binary search finds split
// t's run and the thread adds its prefix differences in order.  With
// num_splits = 1 this is the seg fix-up straight into y; with NS > 1 it
// fills the split partials stage 2 reduces, and a monster row's chain is
// walked by NS threads instead of one.  Padded piece rows
// [0, 1, 0, 0, 0] (lo > hi) are skipped and can never add anything.
#include "common.cuh"

namespace {

__global__ void seg_psum_kernel(const float* __restrict__ vals,
                                const int* __restrict__ cols,
                                const float* __restrict__ x,
                                long long x_stride,
                                const int* __restrict__ sids, int C, int L,
                                int Lx, int B, float* __restrict__ psum) {
  __shared__ float warp_tot[WARP];
  const int k = blockIdx.x / C, c = blockIdx.x % C, b = blockIdx.y;
  const int sid = sids[k];
  const int l = threadIdx.x;
  const float* xv = shard_x(x, x_stride, sid, b, Lx);
  const long long off = ((long long)sid * C + c) * L + l;
  const float v = block_inclusive_scan(__fmul_rn(vals[off], xv[cols[off]]),
                                       warp_tot);
  psum[(((long long)k * B + b) * C + c) * L + l] = v;
}

__device__ __forceinline__ int first_piece_of_split(const int* pc, int lo,
                                                    int hi, int t) {
  // Pieces of one row are split-ordered: binary search for split >= t.
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (pc[mid * 5 + 4] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void seg_fixup_kernel(const float* __restrict__ psum,
                                 const int* __restrict__ pieces,
                                 const int* __restrict__ piece_ptr,
                                 const int* __restrict__ sids,
                                 const int* __restrict__ out_ids, int n_sids,
                                 int C, int L, int Pp, int R, int NS, int B,
                                 float* __restrict__ out) {
  // One thread per (shard, split t, row r): a monster row's carry chain
  // is cut into NS independent runs, one per split.
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)n_sids * NS * R) return;
  const int r = (int)(item % R);
  const int t = (int)((item / R) % NS);
  const int k = (int)(item / ((long long)R * NS)), b = blockIdx.y;
  const int sid = sids[k];
  const float* ps = psum + ((long long)k * B + b) * C * L;
  const int* pc = pieces + (long long)sid * Pp * 5;
  const int* ptr = piece_ptr + (long long)sid * (R + 1);
  int p = ptr[r];
  const int pe = ptr[r + 1];
  if (NS > 1) p = first_piece_of_split(pc, p, pe, t);
  float acc = 0.f;
  for (; p < pe && pc[p * 5 + 4] == t; ++p) {
    const int lo = pc[p * 5 + 1], hi = pc[p * 5 + 2];
    if (lo > hi) continue;
    const float* row = ps + (long long)pc[p * 5] * L;
    const float d = lo > 0 ? __fsub_rn(row[hi], row[lo - 1]) : row[hi];
    acc = __fadd_rn(acc, d);
  }
  out[(((long long)out_ids[k] * B + b) * NS + t) * R + r] = acc;
}

}  // namespace

RT_API int rt_seg_psum(const float* vals, const int* cols, const float* x,
                       long long x_stride, const int* sids, int n_sids, int C,
                       int L, int Lx, int B, float* psum, void* stream) {
  if ((long long)n_sids * C == 0 || B == 0) return 0;
  dim3 grid((unsigned)(n_sids * C), (unsigned)B);
  seg_psum_kernel<<<grid, L, 0, (cudaStream_t)stream>>>(
      vals, cols, x, x_stride, sids, C, L, Lx, B, psum);
  return (int)cudaGetLastError();
}

RT_API int rt_seg_fixup(const float* psum, const int* pieces,
                        const int* piece_ptr, const int* sids,
                        const int* out_ids, int n_sids, int C, int L, int Pp,
                        int R, int NS, int B, float* out, void* stream) {
  const long long items = (long long)n_sids * NS * R;
  if (items == 0 || B == 0) return 0;
  constexpr int THREADS = 256;
  dim3 grid((unsigned)((items + THREADS - 1) / THREADS), (unsigned)B);
  seg_fixup_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      psum, pieces, piece_ptr, sids, out_ids, n_sids, C, L, Pp, R, NS, B,
      out);
  return (int)cudaGetLastError();
}
