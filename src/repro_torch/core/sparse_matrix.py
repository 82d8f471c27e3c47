"""Sparse matrix containers and format conversions (host, numpy).

The port's own copy of the host formats of ``repro.core.sparse_matrix``:
CSR as the canonical host format, padded ELL (+ COO overflow = HYB), the
nonzero-balanced segmented stream (SEG), its split-nnz variant (SPLIT),
the bitmask-tiled layout (TILE) and block CSR (BCSR, which only the
deprecated Block-ELL shims take).  The arithmetic is the reference's
exactly, so every array built here is bitwise-equal to the one the JAX
package builds from the same CSR.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "ELL_LANE",
    "ELL_SUBLANE",
    "BcsrMatrix",
    "CSRMatrix",
    "EllMatrix",
    "SegMatrix",
    "SplitMatrix",
    "TileMatrix",
    "csr_from_coo",
    "csr_matvec",
    "csr_to_bcsr",
    "csr_to_dense",
    "csr_to_ell",
    "csr_to_tile",
    "csr_row_nnz",
    "hyb_cap_width",
]

#: Tiling of the padded ELL slab: width is rounded to a multiple of
#: ``ELL_LANE``, rows to a multiple of ``ELL_SUBLANE`` (the reference's
#: lowering parameters, kept so both packages lower identical slabs).
ELL_LANE = 128
ELL_SUBLANE = 8


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Standard CSR: values / col_index / row_ptr (host, numpy)."""

    shape: Tuple[int, int]
    values: np.ndarray      # (nnz,) float
    col_index: np.ndarray   # (nnz,) int32
    row_ptr: np.ndarray     # (M+1,) int64

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_slice(self, r0: int, r1: int) -> "CSRMatrix":
        """Mini-CSR for rows [r0, r1) with *relative* row offsets."""
        lo, hi = int(self.row_ptr[r0]), int(self.row_ptr[r1])
        return CSRMatrix(
            shape=(r1 - r0, self.shape[1]),
            values=self.values[lo:hi],
            col_index=self.col_index[lo:hi],
            row_ptr=(self.row_ptr[r0 : r1 + 1] - lo).astype(np.int64),
        )

    def permuted(self, row_perm: np.ndarray, col_perm: np.ndarray) -> "CSRMatrix":
        """Return P_r A P_c^T as CSR.  perm[i] = new index of old row/col i."""
        M, N = self.shape
        old_rows = np.repeat(np.arange(M), np.diff(self.row_ptr))
        new_rows = row_perm[old_rows]
        new_cols = col_perm[self.col_index]
        order = np.lexsort((new_cols, new_rows))
        nr, nc, nv = new_rows[order], new_cols[order], self.values[order]
        row_ptr = np.zeros(M + 1, dtype=np.int64)
        np.add.at(row_ptr, nr + 1, 1)
        np.cumsum(row_ptr, out=row_ptr)
        return CSRMatrix(shape=self.shape, values=nv,
                         col_index=nc.astype(np.int32), row_ptr=row_ptr)


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded ELL slab + COO overflow tail (HYB).

    ``data``/``cols`` are (M_pad, W); padded slots hold value 0 / col 0.
    Rows longer than W spill their tail into the row-sorted COO arrays.
    """

    shape: Tuple[int, int]
    data: np.ndarray        # (M_pad, W) float
    cols: np.ndarray        # (M_pad, W) int32
    overflow_rows: np.ndarray  # (nnz_ovf,) int32
    overflow_cols: np.ndarray  # (nnz_ovf,) int32
    overflow_vals: np.ndarray  # (nnz_ovf,) float
    nnz: int

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def padding_ratio(self) -> float:
        dense_slots = self.data.shape[0] * self.data.shape[1]
        ell_nnz = self.nnz - self.overflow_vals.shape[0]
        return 1.0 - ell_nnz / max(dense_slots, 1)


@dataclasses.dataclass(frozen=True)
class BcsrMatrix:
    """Block CSR with dense (bm, bn) blocks: the operand of the deprecated
    Block-ELL shims (``kernels.ops.bell_from_bcsr``)."""

    shape: Tuple[int, int]          # unpadded logical shape
    block_shape: Tuple[int, int]
    blocks: np.ndarray              # (nblocks, bm, bn) float
    block_cols: np.ndarray          # (nblocks,) int32
    block_row_ptr: np.ndarray       # (Mb+1,) int64
    nnz: int                        # scalar non-zeros represented

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def density_in_blocks(self) -> float:
        bm, bn = self.block_shape
        return self.nnz / max(self.nblocks * bm * bn, 1)


@dataclasses.dataclass(frozen=True)
class SegMatrix:
    """Nonzero-balanced segmented format: the CSR nnz stream as a (C, L)
    slab of equal chunks plus per-(chunk, row) pieces.  A piece covering
    in-chunk offsets [lo, hi] adds ``psum[chunk, hi] - psum[chunk, lo-1]``
    to its row."""

    shape: Tuple[int, int]
    chunk: int                 # L, elements per chunk (multiple of ``lane``)
    vals: np.ndarray           # (C, L) float32
    cols: np.ndarray           # (C, L) int32
    rows: np.ndarray           # (C, L) int32 row id per slot (0 on padding)
    piece_chunk: np.ndarray    # (n_pieces,) int32
    piece_lo: np.ndarray       # (n_pieces,) int32 first in-chunk offset
    piece_hi: np.ndarray       # (n_pieces,) int32 last in-chunk offset
    piece_row: np.ndarray      # (n_pieces,) int32 destination row
    nnz: int

    @property
    def num_chunks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_pieces(self) -> int:
        return int(self.piece_row.shape[0])

    @property
    def padding_ratio(self) -> float:
        slots = self.vals.shape[0] * self.vals.shape[1]
        return 1.0 - self.nnz / max(slots, 1)


@dataclasses.dataclass(frozen=True)
class SplitMatrix:
    """Split-nnz two-stage format: a SegMatrix slab whose chunk axis is cut
    into ``num_splits`` equal groups, (NS, Cs, L).  Stage 1 scatters each
    split's pieces into partial row sums (NS, rows); stage 2 reduces the
    split axis.  Pieces never cross a split boundary."""

    shape: Tuple[int, int]
    chunk: int                 # L, elements per chunk (multiple of ``lane``)
    num_splits: int            # NS
    vals: np.ndarray           # (NS, Cs, L) float32
    cols: np.ndarray           # (NS, Cs, L) int32
    rows: np.ndarray           # (NS, Cs, L) int32 row id per slot (0 on pad)
    piece_split: np.ndarray    # (n_pieces,) int32 owning split
    piece_chunk: np.ndarray    # (n_pieces,) int32 chunk *within* its split
    piece_lo: np.ndarray       # (n_pieces,) int32 first in-chunk offset
    piece_hi: np.ndarray       # (n_pieces,) int32 last in-chunk offset
    piece_row: np.ndarray      # (n_pieces,) int32 destination row
    nnz: int

    @property
    def chunks_per_split(self) -> int:
        return int(self.vals.shape[1])

    @property
    def n_pieces(self) -> int:
        return int(self.piece_row.shape[0])

    @property
    def padding_ratio(self) -> float:
        slots = self.vals.shape[0] * self.vals.shape[1] * self.vals.shape[2]
        return 1.0 - self.nnz / max(slots, 1)


@dataclasses.dataclass(frozen=True)
class TileMatrix:
    """Two-level bitmask-tiled layout: a CSR-like pointer grid over the
    occupied dense ``(bm, bn)`` tiles (sorted by block row, then block
    column) plus a packed per-tile occupancy bitmask."""

    shape: Tuple[int, int]
    bm: int                    # tile rows
    bn: int                    # tile cols
    tile_ptr: np.ndarray       # (Mb+1,) int32 pointer grid over block rows
    tile_rows: np.ndarray      # (T,) int32 block-row id per tile
    tile_cols: np.ndarray      # (T,) int32 block-col id per tile
    data: np.ndarray           # (T, bm, bn) float32, zero-filled
    mask: np.ndarray           # (T, bm, bn//8) uint8 packed occupancy bits
    nnz: int

    @property
    def num_tiles(self) -> int:
        return int(self.data.shape[0])

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.bm, self.bn)

    @property
    def fill_ratio(self) -> float:
        return self.nnz / max(self.num_tiles * self.bm * self.bn, 1)

    @property
    def max_tiles_per_block_row(self) -> int:
        counts = np.diff(self.tile_ptr)
        return int(counts.max()) if counts.size else 0

    def occupancy(self) -> np.ndarray:
        """Unpacked (T, bm, bn) boolean occupancy from the bitmask."""
        bits = np.unpackbits(self.mask, axis=2, count=self.bn)
        return bits.astype(bool)


def csr_to_tile(csr: CSRMatrix, bm: int = ELL_SUBLANE,
                bn: int = ELL_LANE) -> TileMatrix:
    """Convert CSR -> two-level bitmask-tiled layout (occupied tiles only).
    ``bn`` must be a multiple of 8 so the bitmask packs along the lanes."""
    if bn % 8:
        raise ValueError(f"bn must be a multiple of 8, got {bn}")
    M, N = csr.shape
    Mb = max(-(-M // bm), 1)
    Nb = max(-(-N // bn), 1)
    rows = np.repeat(np.arange(M, dtype=np.int64), csr_row_nnz(csr))
    brow = rows // bm
    bcol = csr.col_index.astype(np.int64) // bn
    key = brow * Nb + bcol
    uniq, inverse = np.unique(key, return_inverse=True)
    T = int(uniq.shape[0])
    data = np.zeros((T, bm, bn), dtype=np.float32)
    occ = np.zeros((T, bm, bn), dtype=bool)
    if T:
        lr = (rows % bm).astype(np.int64)
        lc = (csr.col_index.astype(np.int64) % bn)
        np.add.at(data, (inverse, lr, lc), csr.values.astype(np.float32))
        occ[inverse, lr, lc] = True
    tile_rows = (uniq // Nb).astype(np.int32)
    tile_cols = (uniq % Nb).astype(np.int32)
    tile_ptr = np.zeros(Mb + 1, dtype=np.int32)
    np.add.at(tile_ptr, tile_rows + 1, 1)
    np.cumsum(tile_ptr, out=tile_ptr)
    return TileMatrix(shape=csr.shape, bm=bm, bn=bn, tile_ptr=tile_ptr,
                      tile_rows=tile_rows, tile_cols=tile_cols, data=data,
                      mask=np.packbits(occ, axis=2), nnz=csr.nnz)


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: Tuple[int, int], sum_duplicates: bool = True) -> CSRMatrix:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        key_change = np.empty(rows.size, dtype=bool)
        key_change[0] = True
        key_change[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        group = np.cumsum(key_change) - 1
        uvals = np.zeros(group[-1] + 1, dtype=vals.dtype)
        np.add.at(uvals, group, vals)
        rows, cols, vals = rows[key_change], cols[key_change], uvals
    M = shape[0]
    row_ptr = np.zeros(M + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    np.cumsum(row_ptr, out=row_ptr)
    return CSRMatrix(shape=shape, values=vals.astype(np.float64),
                     col_index=cols.astype(np.int32), row_ptr=row_ptr)


def csr_row_nnz(csr: CSRMatrix) -> np.ndarray:
    return np.diff(csr.row_ptr)


def csr_to_dense(csr: CSRMatrix) -> np.ndarray:
    out = np.zeros(csr.shape, dtype=csr.values.dtype)
    rows = np.repeat(np.arange(csr.nrows), csr_row_nnz(csr))
    out[rows, csr.col_index] = csr.values
    return out


def csr_matvec(csr: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Exact host y = A @ x straight off the CSR arrays (float64 numpy).

    ``x`` is (ncols,) or (ncols, B); the result matches shape.  Never
    densifies, so it is the oracle every port check holds results to.
    """
    rows = np.repeat(np.arange(csr.nrows), csr_row_nnz(csr))
    contrib = csr.values.astype(np.float64)
    xs = np.asarray(x, dtype=np.float64)[csr.col_index]
    if xs.ndim == 2:
        contrib = contrib[:, None] * xs
        y = np.zeros((csr.nrows, xs.shape[1]), dtype=np.float64)
    else:
        contrib = contrib * xs
        y = np.zeros(csr.nrows, dtype=np.float64)
    np.add.at(y, rows, contrib)
    return y


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def csr_to_ell(csr: CSRMatrix, lane: int = ELL_LANE, sublane: int = ELL_SUBLANE,
               max_width: int | None = None) -> EllMatrix:
    """Convert to padded ELL (+ COO overflow when ``max_width`` caps W)."""
    M = csr.nrows
    nnz_per_row = csr_row_nnz(csr)
    natural = int(nnz_per_row.max()) if M else 0
    W = _round_up(max(natural, 1), lane)
    if max_width is not None:
        W = min(W, _round_up(max_width, lane))
    M_pad = _round_up(max(M, 1), sublane)

    data = np.zeros((M_pad, W), dtype=np.float32)
    cols = np.zeros((M_pad, W), dtype=np.int32)
    rows_of_nnz = np.repeat(np.arange(M), nnz_per_row)
    pos_in_row = np.arange(csr.nnz, dtype=np.int64) - csr.row_ptr[rows_of_nnz]
    fits = pos_in_row < W
    data[rows_of_nnz[fits], pos_in_row[fits]] = csr.values[fits]
    cols[rows_of_nnz[fits], pos_in_row[fits]] = csr.col_index[fits]
    spill = ~fits
    orows = rows_of_nnz[spill].astype(np.int32)
    ocols = csr.col_index[spill].astype(np.int32)
    ovals = csr.values[spill].astype(np.float32)
    return EllMatrix(shape=csr.shape, data=data, cols=cols,
                     overflow_rows=orows, overflow_cols=ocols,
                     overflow_vals=ovals, nnz=csr.nnz)


def hyb_cap_width(row_nnz: np.ndarray, lane: int = ELL_LANE) -> int:
    """Lane-aligned HYB width cap: the 95th percentile row length rounded
    up to a ``lane`` multiple, so the heaviest ~5% of rows spill."""
    row_nnz = np.asarray(row_nnz)
    if row_nnz.size == 0:
        return lane
    p95 = float(np.percentile(row_nnz, 95))
    return _round_up(max(int(np.ceil(p95)), 1), lane)


def csr_to_bcsr(csr: CSRMatrix,
                block_shape: Tuple[int, int] = (128, 128)) -> BcsrMatrix:
    """Convert CSR -> block CSR over the occupied (bm, bn) blocks (one
    all-zero block when the matrix is empty)."""
    bm, bn = block_shape
    M, N = csr.shape
    Mb = (M + bm - 1) // bm
    rows = np.repeat(np.arange(M), csr_row_nnz(csr))
    brow = rows // bm
    bcol = csr.col_index // bn
    key = brow.astype(np.int64) * ((N + bn - 1) // bn) + bcol
    uniq, inverse = np.unique(key, return_inverse=True)
    nblocks = uniq.shape[0]
    blocks = np.zeros((max(nblocks, 1), bm, bn), dtype=np.float32)
    if nblocks:
        lr = (rows % bm).astype(np.int64)
        lc = (csr.col_index % bn).astype(np.int64)
        np.add.at(blocks, (inverse, lr, lc), csr.values.astype(np.float32))
    ub_row = (uniq // ((N + bn - 1) // bn)).astype(np.int64)
    ub_col = (uniq % ((N + bn - 1) // bn)).astype(np.int32)
    block_row_ptr = np.zeros(Mb + 1, dtype=np.int64)
    np.add.at(block_row_ptr, ub_row + 1, 1)
    np.cumsum(block_row_ptr, out=block_row_ptr)
    return BcsrMatrix(shape=csr.shape, block_shape=block_shape, blocks=blocks,
                      block_cols=ub_col, block_row_ptr=block_row_ptr,
                      nnz=csr.nnz)
