// Padded-ELL SpMV with the HYB overflow tail fused.
//
// Replaces: src/repro/kernels/spmv_ell.py ell_spmv (_ell_kernel,
// pallas_call at :60), plus the jnp COO overflow scatter that followed it
// on the device path (src/repro/core/program.py:863-867).
//
// y[s, b, r] = sum_{w < ell_len[s, r]} data[s, r, w] * x[s, cols[s, r, w], b]
//            + sum over r's overflow range of ovf_vals * x[ovf_cols]
//
// What bounds it on the H100: bytes.  Each real slot moves 8 bytes of
// data + cols and one 4-byte gather of x for 2 flops, far below the card's
// ~20 flop/byte fp32 balance point.  The TPU kernel kept all of x in VMEM
// and multiplied every slot of the (tile_m, W) block; here x stays in
// device memory (one shard's x is at most a few MB and stays L2-resident)
// and only the real slots are read.  The executor's stacked slabs are
// padded to the widest shard and hold zero-length rows for every row the
// other pass owns, so on cop20k_A the real slots are 21 MB of the ~250 MB
// slab.
//
// Design: a group of G = 8 lanes per row (tools/kernel_variants.py times
// 4, 8, 16 and 32).  ell_len (S, R) gives each row's real slot count: the group
// walks slots 0 .. ell_len) only, G consecutive slots a step (one 32-byte
// sector of data and of cols at G = 8), each lane loading K slots before
// it uses any so the loads overlap; a row of length 0 costs one 4-byte
// read.  A null ell_len means every row has W real slots (the per-format
// API's caller-padded slab).  Each lane keeps one sum a column of x for
// RHS_CHUNK columns, so one slot load feeds every column; a fixed
// butterfly over the group then reduces the lane sums, and the group's
// first lane adds the row's overflow entries in their stored (row-sorted)
// order, each column in the order of the single-vector call (batched
// columns equal it bitwise).  x is batch-minor, so a slot's columns are
// one row of x (load_x_row: 16-byte loads where B % 4 == 0).  The
// overflow range comes from a host table (ovf_ptr, (S, R+1)) built with
// searchsorted over the shard's real overflow entries, so the unsorted
// stacking padding is never read.
// Padded slots (col 0 / value 0) are never read, so for finite x the
// result equals the full-slot walk's up to the sign of a zero.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int G = 8;              // lanes a row (4, 8, 16 or 32)
constexpr int K = 4;              // slots a lane loads before using any

template <int NB>
__global__ void ell_spmv_kernel(const float* __restrict__ data,
                                const int* __restrict__ cols,
                                const int* __restrict__ ell_len,
                                const int* __restrict__ ovf_ptr,
                                const int* __restrict__ ovf_cols,
                                const float* __restrict__ ovf_vals,
                                const float* __restrict__ x,
                                long long x_stride,
                                const int* __restrict__ sids, int n_sids,
                                int R, int W, int O, int B,
                                float* __restrict__ y) {
  const int lane = threadIdx.x % WARP, sub = lane % G;
  const long long item = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
  if (item >= (long long)n_sids * R) return;   // whole groups leave together
  const unsigned group =
      G == WARP ? FULL_MASK : ((1u << (G % WARP)) - 1u) << (lane - sub);
  const int k = (int)(item / R), r = (int)(item % R);
  const int b0 = blockIdx.y * NB, nb = min(NB, B - b0);
  const int sid = sids[k];
  const float* xv = shard_x(x, x_stride, sid, b0);
  const bool vec = x_rows_vec(x, B);
  const long long row = (long long)sid * R + r;
  const int len = ell_len == nullptr ? W : ell_len[row];
  const float* d = data + row * W;
  const int* c = cols + row * W;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int w0 = sub; w0 < len; w0 += G * K) {
    float dv[K];
    int cv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool real = w0 + G * j < len;
      dv[j] = real ? d[w0 + G * j] : 0.f;
      cv[j] = real ? c[w0 + G * j] : 0;
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (w0 + G * j < len) {
        float xr[NB];
        load_x_row<NB>(x_row<NB>(xv, cv[j], B), nb, vec, xr);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b < nb) acc[b] = fmaf(dv[j], xr[b], acc[b]);
      }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = group_sum<G>(acc[b], group);
  if (sub == 0) {
    const int* ptr = ovf_ptr + (long long)sid * (R + 1);
    const long long obase = (long long)sid * O;
    for (int o = ptr[r]; o < ptr[r + 1]; ++o) {
      const float v = ovf_vals[obase + o];
      float xr[NB];
      load_x_row<NB>(x_row<NB>(xv, ovf_cols[obase + o], B), nb, vec, xr);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b < nb) acc[b] = __fadd_rn(acc[b], __fmul_rn(v, xr[b]));
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) y[((long long)sid * B + b0 + b) * R + r] = acc[b];
  }
}

}  // namespace

// ell_len (S, R) real slots a row, or null (W for every row).
RT_API int rt_ell_spmv(const float* data, const int* cols, const int* ell_len,
                       const int* ovf_ptr, const int* ovf_cols,
                       const float* ovf_vals, const float* x,
                       long long x_stride, const int* sids, int n_sids, int R,
                       int W, int O, int B, float* y, void* stream) {
  const long long rows = (long long)n_sids * R;
  if (rows == 0 || B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks =
      (unsigned)((rows + THREADS / G - 1) / (THREADS / G));
  if (B == 1)
    ell_spmv_kernel<1><<<blocks, THREADS, 0, s>>>(
        data, cols, ell_len, ovf_ptr, ovf_cols, ovf_vals, x, x_stride, sids,
        n_sids, R, W, O, B, y);
  else
    ell_spmv_kernel<RHS_CHUNK>
        <<<dim3(blocks, (B + RHS_CHUNK - 1) / RHS_CHUNK), THREADS, 0, s>>>(
            data, cols, ell_len, ovf_ptr, ovf_cols, ovf_vals, x, x_stride,
            sids, n_sids, R, W, O, B, y);
  return (int)cudaGetLastError();
}
