"""The port's kernels: CUDA sources in ``repro_torch/csrc``, ctypes
wrappers with launch counts, each kernel's plain PyTorch version, and the
per-format kernel API of ``repro.kernels`` on top of them.

* ``spmv_ell``   — padded-ELL SpMV with the HYB overflow tail fused;
* ``spmv_seg``   — per-chunk prefix sums and the carry fix-up;
* ``spmv_split`` — stage 1 over the split slab, the split combine, and
  the fix-up and combine fused (``split_fixup``, the split paths' own);
* ``spmv_tile``  — the tile walks (flat device operands, and one
  TileMatrix addressed by block column);
* ``exchange``   — the executor's exchange's row gather of x;
* ``ref``        — the PyTorch oracles and the plain versions;
* ``ops``        — the format builders, the per-format API re-exported
  here, and the executor's stacked ops.

Every op takes x of shape (N,) or (N, B) and runs on ``device``, CUDA
unless the caller passes ``device="cpu"``, where the kernels' plain
versions run.  A ``SegMatrix``, ``SplitMatrix`` or ``TileMatrix`` keeps
its device form (arrays on the device, the piece table) after its first
call on a device; raw array tuples are converted on every call.

Examples
--------
The ELL oracle against a dense product:

>>> import numpy as np
>>> from repro_torch.kernels import ell_spmv_ref
>>> data = np.array([[2.0, 0.0], [1.0, 3.0]], np.float32)
>>> cols = np.array([[1, 0], [0, 1]], np.int32)
>>> x = np.array([1.0, 10.0], np.float32)
>>> ell_spmv_ref(data, cols, x).tolist()   # [2*10, 1*1+3*10]
[20.0, 31.0]

The segmented path built straight from a CSR matrix:

>>> from repro_torch.core.sparse_matrix import csr_from_coo, csr_to_dense
>>> from repro_torch.kernels import seg_from_csr, seg_spmv
>>> A = csr_from_coo(np.array([0, 1, 1]), np.array([1, 0, 1]),
...                  np.array([5.0, 2.0, 4.0]), (2, 2))
>>> seg = seg_from_csr(A, chunk=128)
>>> y = seg_spmv(seg, np.array([1.0, 2.0], np.float32), device="cpu")
>>> np.allclose(y.numpy(), csr_to_dense(A) @ np.array([1.0, 2.0]))
True

The split-K path from the same matrix (two splits asked, clamped to the
one chunk):

>>> from repro_torch.kernels import split_from_csr, split_spmv
>>> spl = split_from_csr(A, 2, chunk=128)
>>> y2 = split_spmv(spl, np.array([1.0, 2.0], np.float32), device="cpu")
>>> np.allclose(y2.numpy(), y.numpy())
True

The bitmask-tiled path from the same matrix (one occupied (8, 128) tile):

>>> from repro_torch.kernels import tile_from_csr, tile_spmv
>>> tl = tile_from_csr(A)
>>> tl.num_tiles
1
>>> y3 = tile_spmv(tl, np.array([1.0, 2.0], np.float32), device="cpu")
>>> np.allclose(y3.numpy(), y.numpy())
True
"""
from .ops import (bell_from_bcsr, bell_spmm, bell_spmv, ell_spmv,
                  ell_spmv_ref, hyb_spmv, seg_from_csr, seg_spmv,
                  seg_spmv_ref, split_flat_spmv, split_from_csr, split_spmv,
                  split_spmv_ref, tile_flat_spmv, tile_from_csr, tile_spmv,
                  tile_spmv_ref)

__all__ = ["ell_spmv", "ell_spmv_ref", "hyb_spmv", "bell_spmv", "bell_spmm",
           "bell_from_bcsr", "seg_spmv", "seg_spmv_ref", "seg_from_csr",
           "split_spmv", "split_spmv_ref", "split_from_csr",
           "split_flat_spmv", "tile_spmv", "tile_spmv_ref", "tile_from_csr",
           "tile_flat_spmv"]
