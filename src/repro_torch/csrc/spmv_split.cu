// Split-nnz SpMV: stage 1's per-chunk prefix sums over the split slab,
// and stage 2, the reduction of the per-split partial row sums.
//
// Replaces: src/repro/kernels/spmv_split.py split_psum
// (_split_psum_kernel, pallas_call at :58) and split_combine
// (_split_combine_kernel, pallas_call at :84).  Between them the carry
// fix-up runs as seg_fixup with num_splits = NS (spmv_seg.cu), on the
// reference's device path (src/repro/kernels/ops.py:339-343) as on its
// host op split_spmv (ops.py:310-315, the jnp _split_fixup :257).  The
// port's executor and split_spmv run neither that fix-up nor this combine:
// split_fixup (spmv_seg.cu) sums each row's runs in split order straight
// into y, bitwise the pair, with no (n, B, NS, R) partials in between.
//
// split_psum:    psum[b, s, c, l] = sum_{j <= l} vals[s, c, j] * x[cols[s, c, j], b]
// split_combine: y[s, b, r] = sum_{t < NS} part[k, b, t, r]   (t in split order)
//
// What bounds them on the H100: bytes.  split_psum reads 8 bytes of
// vals + cols, gathers 4 bytes of x and writes 4 bytes per element and
// column for one multiply and one add; split_combine reads NS * R partials
// and writes R values, one add per 4 bytes read.
//
// Design.  The TPU's 2-D (NS, Cs / tc) grid existed so that a slab of
// few chunks still filled the grid steps; on Hopper every chunk of the
// (NS * Cs, L) view is independent anyway, and that view is exactly one
// shard of seg_psum's operands with one shared x: split_psum is
// seg_psum's warp-per-chunk scan (launch_seg_psum, spmv_seg.cu) on it,
// so one 16-byte load of vals and cols feeds up to RHS_CHUNK columns, a
// chunk of any length L % 4 == 0 is walked in steps, Cs needs no sublane
// padding and NS no divisor, and the result is seg_psum's, bitwise.
// split_combine: one thread owns one row and walks the split axis, so
// neighbouring threads read neighbouring rows (coalesced) and the sum
// order is fixed: deterministic, no atomics.
#include "common.cuh"

namespace {

__global__ void split_combine_kernel(const float* __restrict__ part,
                                     const int* __restrict__ sids, int n_sids,
                                     int NS, int R, int B,
                                     float* __restrict__ y) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)n_sids * R) return;
  const int k = (int)(item / R), r = (int)(item % R), b = blockIdx.y;
  const float* p = part + ((long long)k * B + b) * NS * R + r;
  float acc = 0.f;
  for (int t = 0; t < NS; ++t) acc = __fadd_rn(acc, p[(long long)t * R]);
  y[((long long)sids[k] * B + b) * R + r] = acc;
}

}  // namespace

// C = NS * Cs chunks of L elements; x is (n, B), psum (B, C, L): seg_psum's
// scan on one shard (the slab), x as one shared (1, n, B) buffer.
RT_API int rt_split_psum(const float* vals, const int* cols, const float* x,
                         int C, int L, int B, float* psum, void* stream) {
  return launch_seg_psum(vals, cols, x, 0, nullptr, 1, C, L, B, psum,
                         (cudaStream_t)stream);
}

RT_API int rt_split_combine(const float* part, const int* sids, int n_sids,
                            int NS, int R, int B, float* y, void* stream) {
  const long long items = (long long)n_sids * R;
  if (items == 0 || B == 0) return 0;
  constexpr int THREADS = 256;
  dim3 grid((unsigned)((items + THREADS - 1) / THREADS), (unsigned)B);
  split_combine_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      part, sids, n_sids, NS, R, B, y);
  return (int)cudaGetLastError();
}
