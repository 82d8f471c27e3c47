"""The plain reference that decides ``correct``, and its control.

``Reference.matmul`` is a float64 CSR product in plain PyTorch: one gather of
x by column, one product, one ``index_add_`` by row, in blocks of rows
so that no temporary passes ``BLOCK_ELEMS`` elements.  It reads only the
benchmark's own CSR and x, never anything the program made.

``norm_error`` is the number compared: in each column, the largest gap
between an answer and the float64 product over the largest
``(|A| @ |x|)`` of any row, the largest over the columns.  It is a
normwise error, not a row-wise one, because the program's seg kernels
sum a row as the difference of two running sums over a chunk of 512
nonzeros: a row's float32 error follows the chunk's running sum, not the
row's own magnitude, and a short row next to long ones reads a row-wise
error of 1e-2 where the bfloat16 control reads 7e-3.  Normwise the two
lie four orders of magnitude apart.

The control (``dtype=torch.bfloat16``) is the same product with the
matrix and x rounded to bfloat16 and the products summed in float32:
the step below float32, which stores the matrix in half the bytes.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BLOCK_ELEMS", "Reference", "norm_error"]

#: The most (nonzero, column) products one block of rows holds.
BLOCK_ELEMS = 1 << 27


class Reference:
    """The benchmark's CSR uploaded once to ``device`` for products."""

    def __init__(self, csr, device):
        self.shape = csr.shape
        self.device = torch.device(device)
        self.row_ptr = np.asarray(csr.row_ptr, dtype=np.int64)
        nnz_rows = np.diff(self.row_ptr)
        self.rows = torch.from_numpy(
            np.repeat(np.arange(csr.shape[0], dtype=np.int64), nnz_rows)) \
            .to(self.device)
        self.cols = torch.from_numpy(csr.col_index.astype(np.int64)) \
            .to(self.device)
        self.values = torch.from_numpy(csr.values).to(self.device)

    def _blocks(self, width: int):
        """Row ranges [r0, r1) whose products fit in BLOCK_ELEMS."""
        per = max(BLOCK_ELEMS // max(width, 1), 1)
        M, r0 = self.shape[0], 0
        while r0 < M:
            lo = self.row_ptr[r0]
            r1 = int(np.searchsorted(self.row_ptr, lo + per, side="right")) - 1
            r1 = min(max(r1, r0 + 1), M)
            yield r0, r1
            r0 = r1

    def matmul(self, X: torch.Tensor, *, absolute: bool = False,
               dtype=torch.float64) -> torch.Tensor:
        """A @ X (or |A| @ |X|) for X (N, k), as float64 (M, k).

        ``dtype=torch.bfloat16`` computes the control: A and X rounded to
        bfloat16, products and sums in float32."""
        X = X.to(self.device, torch.float64)
        vals = self.values
        if absolute:
            X, vals = X.abs(), vals.abs()
        acc = torch.float64
        if dtype != torch.float64:
            X = X.to(dtype).float()
            vals = vals.to(dtype).float()
            acc = torch.float32
        M, k = self.shape[0], X.shape[1]
        out = torch.zeros((M, k), dtype=acc, device=self.device)
        for r0, r1 in self._blocks(k):
            lo, hi = int(self.row_ptr[r0]), int(self.row_ptr[r1])
            prod = vals[lo:hi, None].to(acc) * X[self.cols[lo:hi]]
            out.index_add_(0, self.rows[lo:hi], prod)
        return out.double()


def norm_error(got: torch.Tensor, want: torch.Tensor,
               scale: torch.Tensor) -> float:
    """The largest gap between ``got`` and ``want`` in a column over that
    column's largest ``(|A| @ |x|)``, the largest over the columns.  A
    non-finite answer, or any gap in a column whose scale is 0, reads as
    infinity."""
    got = got.to(want.device, torch.float64)
    if got.shape != want.shape:
        raise ValueError(f"answer of shape {tuple(got.shape)}, expected "
                         f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    if not got.numel():
        return 0.0
    gap = (got - want).abs().amax(dim=0)
    top = scale.amax(dim=0)
    ratio = torch.where(top > 0, gap / top.clamp_min(1e-300),
                        torch.where(gap > 0, torch.inf, 0.0))
    return float(ratio.max())
