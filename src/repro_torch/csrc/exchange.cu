// The exchange's row gather: dst[i, :] = src[idx[i], :], a row being one
// element's B columns of the batch-minor x.
//
// Replaces: ATen's advanced-indexing gather that built the remote pass's
// buffers (repro_torch/core/program.py _index_exchange, and the halo's
// packing); on the reference's device path the same rows come from
// jnp.take on the batch-minor x (src/repro/core/program.py:889), an XLA
// gather, not a pallas_call.
//
// gather_rows: dst[i, b] = src[idx[i], b]   (i < n_rows, b < B)
//
// What bounds it on the H100: bytes.  Each output row reads one source row
// (B * 4 bytes, scattered: one 32-byte sector at B = 8) and its 8-byte
// index, and writes B * 4 bytes, coalesced.  On an H100, ATen's gather of
// (N, 8) rows took 3.93 ms for audikw_1.block8's 209 MB buffer, 6x its
// gather of the same bytes batch-major (0.62 ms) and 63x its B = 1 gather.
//
// Design: where B % 4 == 0 and both buffers are 16-byte aligned a thread
// moves one row in 16-byte words (at B = 8 two loads of one sector), else
// IN_FLIGHT rows in 4-byte words; a thread's indices, then IN_FLIGHT
// words' loads, go out before any of their stores, and neighbouring
// threads store neighbouring rows.  On an H100, four rows a thread ran B
// = 8 at 0.313 ms, one 0.198 ms; one row a thread ran B = 1 at 0.0649 ms,
// four 0.0625 ms (ATen 0.0605).  No arithmetic, so dst is src's bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int IN_FLIGHT = 4;      // words a thread loads before it stores

// ROWS rows a thread, W words of type V a row: thread t of block k moves
// rows k * THREADS * ROWS + u * THREADS + t (u < ROWS), so each store is
// coalesced with its neighbours', IN_FLIGHT / ROWS words of each at once.
template <class V, int ROWS>
__global__ void gather_rows_kernel(const V* __restrict__ src,
                                   const long long* __restrict__ idx,
                                   long long n_rows, int W,
                                   V* __restrict__ dst) {
  constexpr int WORDS = IN_FLIGHT / ROWS;
  const long long i0 = (long long)blockIdx.x * THREADS * ROWS + threadIdx.x;
  long long r[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const long long i = i0 + u * THREADS;
    r[u] = i < n_rows ? idx[i] : -1;
  }
  for (int q0 = 0; q0 < W; q0 += WORDS) {
    V v[ROWS][WORDS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
#pragma unroll
      for (int q = 0; q < WORDS; ++q)
        if (r[u] >= 0 && q0 + q < W) v[u][q] = src[r[u] * W + q0 + q];
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
#pragma unroll
      for (int q = 0; q < WORDS; ++q)
        if (r[u] >= 0 && q0 + q < W)
          dst[(i0 + u * THREADS) * W + q0 + q] = v[u][q];
  }
}

template <class V, int ROWS>
void launch_gather(const float* src, const long long* idx, long long n_rows,
                   int W, float* dst, cudaStream_t s) {
  const unsigned blocks =
      (unsigned)((n_rows + THREADS * ROWS - 1) / (THREADS * ROWS));
  gather_rows_kernel<V, ROWS><<<blocks, THREADS, 0, s>>>(
      reinterpret_cast<const V*>(src), idx, n_rows, W,
      reinterpret_cast<V*>(dst));
}

}  // namespace

// src (N, B), idx (n_rows,) int64 rows of src, dst (n_rows, B).
RT_API int rt_gather_rows(const float* src, const long long* idx,
                          long long n_rows, int B, float* dst, void* stream) {
  if (n_rows == 0 || B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = B % 4 == 0 &&
      ((reinterpret_cast<unsigned long long>(src) |
        reinterpret_cast<unsigned long long>(dst)) & 15) == 0;
  if (vec)
    launch_gather<float4, 1>(src, idx, n_rows, B / 4, dst, s);
  else
    launch_gather<float, IN_FLIGHT>(src, idx, n_rows, B, dst, s);
  return (int)cudaGetLastError();
}
