"""Format builders (host, numpy) and the device-path ops of the port.

Counterpart of ``repro.kernels.ops``.  The builders are the reference's
arithmetic exactly, so they produce bitwise-equal slabs.  The device-path
ops run one kernel family over the listed shards of the S-stacked
operands the executor builds:

* x is the batch-major buffer (S or 1, B, Lx) and the result is written
  into ``out`` (S, B, R), rows of the listed shards only;
* each op launches the port's CUDA kernels for CUDA tensors and runs the
  kernels' plain PyTorch versions for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.partition import nnz_chunk_starts
from ..core.sparse_matrix import ELL_LANE, ELL_SUBLANE, EllMatrix, \
    SegMatrix, SplitMatrix, TileMatrix, csr_row_nnz, csr_to_ell, \
    csr_to_tile, hyb_cap_width
from .spmv_ell import ell_spmv as _ell_kernel
from .spmv_seg import seg_fixup, seg_psum
from .spmv_split import split_combine
from .spmv_tile import tile_contrib

__all__ = ["SEG_CHUNK", "hyb_from_csr", "seg_from_csr", "split_from_csr",
           "tile_from_csr", "ell_spmv", "hyb_spmv", "seg_spmv",
           "split_flat_spmv", "tile_flat_spmv"]

#: Default elements per segmented chunk (lane-aligned).
SEG_CHUNK = 512


# --------------------------------------------------------------------------
# format builders (host)
# --------------------------------------------------------------------------

def hyb_from_csr(csr, *, lane: int | None = None,
                 sublane: int | None = None) -> EllMatrix:
    """HYB: ELL capped at :func:`hyb_cap_width` + COO overflow tail."""
    lane = ELL_LANE if lane is None else lane
    sublane = ELL_SUBLANE if sublane is None else sublane
    cap = hyb_cap_width(csr_row_nnz(csr), lane=lane)
    return csr_to_ell(csr, lane=lane, sublane=sublane, max_width=cap)


def _pieces(row_of_nnz: np.ndarray, nnz: int, L: int):
    """Maximal same-row runs within a chunk: (start, end) element ids."""
    is_start = np.zeros(nnz, dtype=bool)
    is_start[0] = True
    is_start[1:] = row_of_nnz[1:] != row_of_nnz[:-1]
    is_start[np.arange(0, nnz, L)] = True
    p_start = np.flatnonzero(is_start)
    p_end = np.concatenate([p_start[1:] - 1, [nnz - 1]])
    return p_start, p_end


def seg_from_csr(csr, *, chunk: int = SEG_CHUNK, lane: int = 128,
                 sublane: int = 8) -> SegMatrix:
    """CSR -> nonzero-balanced SegMatrix (chunk rounded up to ``lane``,
    chunk count to ``sublane``)."""
    L = ((max(chunk, 1) + lane - 1) // lane) * lane
    nnz = csr.nnz
    starts = nnz_chunk_starts(nnz, L)
    C = starts.shape[0] - 1
    C_pad = ((C + sublane - 1) // sublane) * sublane

    vals = np.zeros((C_pad, L), dtype=np.float32)
    cols = np.zeros((C_pad, L), dtype=np.int32)
    rows = np.zeros((C_pad, L), dtype=np.int32)
    row_of_nnz = np.repeat(np.arange(csr.nrows, dtype=np.int64),
                           np.diff(csr.row_ptr))
    flat_c = np.arange(nnz, dtype=np.int64) // L
    flat_l = np.arange(nnz, dtype=np.int64) % L
    vals[flat_c, flat_l] = csr.values
    cols[flat_c, flat_l] = csr.col_index
    rows[flat_c, flat_l] = row_of_nnz
    if nnz:
        p_start, p_end = _pieces(row_of_nnz, nnz, L)
        piece_chunk = (p_start // L).astype(np.int32)
        piece_lo = (p_start % L).astype(np.int32)
        piece_hi = (p_end % L).astype(np.int32)
        piece_row = row_of_nnz[p_start].astype(np.int32)
    else:
        piece_chunk = piece_lo = piece_hi = piece_row = np.zeros(0, np.int32)
    return SegMatrix(shape=csr.shape, chunk=L, vals=vals, cols=cols,
                     rows=rows, piece_chunk=piece_chunk, piece_lo=piece_lo,
                     piece_hi=piece_hi, piece_row=piece_row, nnz=nnz)


def split_from_csr(csr, num_splits: int, *, chunk: int = SEG_CHUNK,
                   lane: int = 128, sublane: int = 8) -> SplitMatrix:
    """CSR -> split-nnz SplitMatrix: the seg chunk grid cut into
    ``num_splits`` (clamped to [1, C]) groups of ``ceil(C / NS)`` chunks."""
    L = ((max(chunk, 1) + lane - 1) // lane) * lane
    nnz = csr.nnz
    starts = nnz_chunk_starts(nnz, L)
    C = starts.shape[0] - 1
    ns = max(1, min(int(num_splits), C))
    Cs = (C + ns - 1) // ns

    vals = np.zeros((ns, Cs, L), dtype=np.float32)
    cols = np.zeros((ns, Cs, L), dtype=np.int32)
    rows = np.zeros((ns, Cs, L), dtype=np.int32)
    row_of_nnz = np.repeat(np.arange(csr.nrows, dtype=np.int64),
                           np.diff(csr.row_ptr))
    flat_g = np.arange(nnz, dtype=np.int64) // L
    s_idx = flat_g // Cs
    c_idx = flat_g % Cs
    l_idx = np.arange(nnz, dtype=np.int64) % L
    vals[s_idx, c_idx, l_idx] = csr.values
    cols[s_idx, c_idx, l_idx] = csr.col_index
    rows[s_idx, c_idx, l_idx] = row_of_nnz
    if nnz:
        p_start, p_end = _pieces(row_of_nnz, nnz, L)
        p_g = p_start // L
        piece_split = (p_g // Cs).astype(np.int32)
        piece_chunk = (p_g % Cs).astype(np.int32)
        piece_lo = (p_start % L).astype(np.int32)
        piece_hi = (p_end % L).astype(np.int32)
        piece_row = row_of_nnz[p_start].astype(np.int32)
    else:
        piece_split = piece_chunk = piece_lo = piece_hi = piece_row = \
            np.zeros(0, np.int32)
    return SplitMatrix(shape=csr.shape, chunk=L, num_splits=ns, vals=vals,
                       cols=cols, rows=rows, piece_split=piece_split,
                       piece_chunk=piece_chunk, piece_lo=piece_lo,
                       piece_hi=piece_hi, piece_row=piece_row, nnz=nnz)


def tile_from_csr(csr, *, bm: int | None = None,
                  bn: int | None = None) -> TileMatrix:
    """CSR -> bitmask-tiled TileMatrix, (8, 128) tiles by default."""
    return csr_to_tile(csr, bm=ELL_SUBLANE if bm is None else bm,
                       bn=ELL_LANE if bn is None else bn)


# --------------------------------------------------------------------------
# device-path ops (one kernel family over the listed shards)
# --------------------------------------------------------------------------

def _out(out, like, S: int, B: int, R: int):
    if out is not None:
        return out
    return torch.empty((S, B, R), dtype=torch.float32, device=like.device)


def hyb_spmv(data, cols, ovf_rows, ovf_cols, ovf_vals, ovf_ptr, x, sids, *,
             out=None):
    """ELL slab + the COO overflow tail, fused in one kernel."""
    return _ell_kernel(data, cols, ovf_rows, ovf_cols, ovf_vals, ovf_ptr, x,
                       sids, out=out)


def ell_spmv(data, cols, x, sids, *, out=None):
    """Padded-ELL SpMV (no overflow tail)."""
    S, R, _ = data.shape
    z = torch.zeros((S, 1), dtype=torch.int32, device=data.device)
    ptr = torch.zeros((S, R + 1), dtype=torch.int32, device=data.device)
    return _ell_kernel(data, cols, z, z, z.float(), ptr, x, sids, out=out)


def _seg_fixup(psum, pieces, piece_ptr, sids, out):
    """Seg carry fix-up straight into y (S, B, R)."""
    return seg_fixup(psum, pieces, piece_ptr, sids, sids, num_splits=1,
                     out=out)


def _split_flat_fixup(psum, pieces, piece_ptr, sids, num_splits: int):
    """Split carry fix-up into per-split partials (n, B, NS, R)."""
    n, B = psum.shape[:2]
    R = piece_ptr.shape[1] - 1
    part = torch.empty((n, B, num_splits, R), dtype=torch.float32,
                       device=psum.device)
    pos = torch.arange(n, dtype=torch.int32, device=psum.device)
    return seg_fixup(psum, pieces, piece_ptr, sids, pos,
                     num_splits=num_splits, out=part)


def seg_spmv(vals, cols, pieces, piece_ptr, x, sids, *, out=None):
    """Segmented SpMV: per-chunk prefix sums, then the carry fix-up."""
    out = _out(out, vals, vals.shape[0], x.shape[1], piece_ptr.shape[1] - 1)
    psum = seg_psum(vals, cols, x, sids)
    return _seg_fixup(psum, pieces, piece_ptr, sids, out)


def split_flat_spmv(vals, cols, pieces, piece_ptr, x, sids, *,
                    num_splits: int, out=None):
    """Split SpMV over the flattened (NS*Cs, L) slab: seg_psum, the
    per-split fix-up, then the split combine."""
    out = _out(out, vals, vals.shape[0], x.shape[1], piece_ptr.shape[1] - 1)
    psum = seg_psum(vals, cols, x, sids)
    part = _split_flat_fixup(psum, pieces, piece_ptr, sids, num_splits)
    return split_combine(part, sids, out=out)


def tile_flat_spmv(data, xcol, brow, tile_ptr, x, sids, *, out=None):
    """Tile SpMV: lane gather, per-tile products and block-row sums in one
    kernel."""
    return tile_contrib(data, xcol, brow, tile_ptr, x, sids, out=out)
