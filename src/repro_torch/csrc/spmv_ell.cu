// Padded-ELL SpMV with the HYB overflow tail fused.
//
// Replaces: src/repro/kernels/spmv_ell.py ell_spmv (_ell_kernel,
// pallas_call at :60), plus the jnp COO overflow scatter that followed it
// on the device path (src/repro/core/program.py:863-867).
//
// y[s, b, r] = sum_w data[s, r, w] * x[s, b, cols[s, r, w]]
//            + sum over r's overflow range of ovf_vals * x[ovf_cols]
//
// What bounds it on the H100: bytes.  Each slot moves 8 bytes of
// data + cols and one 4-byte gather of x for 2 flops, far below the card's
// ~20 flop/byte fp32 balance point.  The TPU kernel kept all of x in VMEM;
// here x stays in device memory and the gathers go through L1/L2 (x of
// one shard is at most a few MB and stays L2-resident).
//
// Design: one warp per row.  Lanes stride the row's W slots, so a warp
// reads 128 contiguous bytes of data and of cols per step (coalesced), and
// a fixed butterfly reduces the lane partials.  Lane 0 then adds the row's
// overflow entries in their stored (row-sorted) order; the range comes
// from a host table (ovf_ptr, (S, R+1)) built with searchsorted over the
// shard's real overflow entries, so the unsorted stacking padding is never
// read.  Padded ELL slots are col 0 / value 0 and add an exact zero.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;

__global__ void ell_spmv_kernel(const float* __restrict__ data,
                                const int* __restrict__ cols,
                                const int* __restrict__ ovf_ptr,
                                const int* __restrict__ ovf_cols,
                                const float* __restrict__ ovf_vals,
                                const float* __restrict__ x,
                                long long x_stride,
                                const int* __restrict__ sids, int n_sids,
                                int R, int W, int O, int Lx, int B,
                                float* __restrict__ y) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long item = (long long)blockIdx.x * ROWS_PER_BLOCK + warp;
  if (item >= (long long)n_sids * R) return;
  const int k = (int)(item / R), r = (int)(item % R), b = blockIdx.y;
  const int sid = sids[k];
  const float* xv = shard_x(x, x_stride, sid, b, Lx);
  const long long base = ((long long)sid * R + r) * W;
  float acc = 0.f;
  for (int w = lane; w < W; w += WARP)
    acc = fmaf(data[base + w], xv[cols[base + w]], acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int* ptr = ovf_ptr + (long long)sid * (R + 1);
    const long long obase = (long long)sid * O;
    for (int o = ptr[r]; o < ptr[r + 1]; ++o)
      acc = __fadd_rn(acc, __fmul_rn(ovf_vals[obase + o],
                                     xv[ovf_cols[obase + o]]));
    y[((long long)sid * B + b) * R + r] = acc;
  }
}

}  // namespace

RT_API int rt_ell_spmv(const float* data, const int* cols, const int* ovf_ptr,
                       const int* ovf_cols, const float* ovf_vals,
                       const float* x, long long x_stride, const int* sids,
                       int n_sids, int R, int W, int O, int Lx, int B,
                       float* y, void* stream) {
  const long long items = (long long)n_sids * R;
  if (items == 0 || B == 0) return 0;
  dim3 grid((unsigned)((items + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK),
            (unsigned)B);
  ell_spmv_kernel<<<grid, ROWS_PER_BLOCK * WARP, 0, (cudaStream_t)stream>>>(
      data, cols, ovf_ptr, ovf_cols, ovf_vals, x, x_stride, sids, n_sids, R,
      W, O, Lx, B, y);
  return (int)cudaGetLastError();
}
