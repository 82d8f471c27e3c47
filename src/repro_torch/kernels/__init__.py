"""The port's kernels: CUDA sources in ``repro_torch/csrc``, ctypes
wrappers with launch counts, and each kernel's plain PyTorch version.

* ``spmv_ell``   — padded-ELL SpMV with the HYB overflow tail fused;
* ``spmv_seg``   — per-chunk prefix sums and the carry fix-up;
* ``spmv_split`` — the split-axis combine (stage 2 of split shards);
* ``spmv_tile``  — bitmask-tiled SpMV with the lane gather and the
  block-row sums fused;
* ``ops``        — the format builders and the per-family device ops.
"""
