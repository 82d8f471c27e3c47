// Split-nnz SpMV, stage 2: reduce the per-split partial row sums.
//
// Replaces: src/repro/kernels/spmv_split.py split_combine
// (_split_combine_kernel, pallas_call at :84).  Stage 1 of the device path
// is seg_psum + seg_fixup with num_splits = NS (spmv_seg.cu), as on the
// reference's device path (src/repro/kernels/ops.py:339-343).
//
// y[s, b, r] = sum_{t < NS} part[k, b, t, r]      (t in split order)
//
// What bounds it on the H100: bytes.  It reads NS * R partials and
// writes R values, one add per 4 bytes read.  The TPU kernel summed a
// (NS, 128) VMEM tile per grid step; here one thread owns one row and
// walks the split axis, so neighbouring threads read neighbouring rows
// (coalesced) and the sum order is fixed: deterministic, no atomics.
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
