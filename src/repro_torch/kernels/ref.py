"""Oracles and plain versions of the port's kernels, in one place.

* The ``*_ref`` functions are PyTorch counterparts of the jnp oracles in
  ``repro.kernels.ref``, under the same names and arguments: the
  order-free answer (gather, multiply, scatter-add) each kernel path must
  reproduce.  They take tensors (or arrays, kept on the CPU) and run where
  the tensors lie; the tests use them, and no card path calls them.
* The ``*_plain`` functions follow each kernel's own arithmetic (gather,
  multiply, ``cumsum``, piece differences, in-order sums) and live beside
  their kernels; a wrapper runs its plain version for a CPU tensor, and
  ``chip_smoke.py`` holds each kernel to it on the card.
"""
from __future__ import annotations

import torch

from .spmv_ell import ell_spmv_plain
from .spmv_seg import seg_fixup_plain, seg_psum_plain
from .spmv_split import split_combine_plain, split_psum_plain
from .spmv_tile import tile_contrib_plain, tile_walk_spmv_plain

__all__ = ["ell_spmv_ref", "bell_spmv_ref", "coo_spmv_ref", "bell_spmm_ref",
           "seg_spmv_ref", "seg_psum_ref", "split_psum_ref",
           "split_partial_ref", "split_combine_ref", "split_spmv_ref",
           "tile_spmv_ref", "tile_flat_spmv_ref",
           "ell_spmv_plain", "seg_psum_plain", "seg_fixup_plain",
           "split_psum_plain", "split_combine_plain", "tile_contrib_plain",
           "tile_walk_spmv_plain"]


def _t(a):
    return torch.as_tensor(a)


def _idx(a):
    return _t(a).long()


def ell_spmv_ref(data, cols, x):
    """y[i] = sum_w data[i, w] * x[cols[i, w]]; x is (N,) or (N, B)."""
    data, x = _t(data), _t(x)
    gathered = x[_idx(cols)]                     # (M, W) or (M, W, B)
    if x.dim() == 2:
        return (data[..., None] * gathered).sum(1)
    return (data * gathered).sum(1)


def coo_spmv_ref(rows, cols, vals, x, num_rows: int):
    """Scatter-add oracle for the HYB overflow tail."""
    contrib = _t(vals) * _t(x)[_idx(cols)]
    return torch.zeros((num_rows,), dtype=contrib.dtype).index_add_(
        0, _idx(rows), contrib)


def seg_spmv_ref(vals, cols, rows, x, num_rows: int):
    """Scatter-add every product of the (C, L) slab into its row; padded
    slots (val 0 / col 0 / row 0) add zeros.  x is (N,) or (N, B)."""
    vals, x = _t(vals), _t(x)
    gathered = x[_idx(cols)]                     # (C, L) or (C, L, B)
    contrib = vals[..., None] * gathered if x.dim() == 2 else vals * gathered
    out = torch.zeros((num_rows,) + tuple(x.shape[1:]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, _idx(rows).reshape(-1),
                          contrib.reshape((-1,) + tuple(x.shape[1:])))


def seg_psum_ref(vals, cols, x):
    """Within-chunk inclusive prefix sums of a (C, L) slab."""
    return torch.cumsum(_t(vals) * _t(x)[_idx(cols)], dim=1)


def split_psum_ref(vals, cols, x):
    """Stage-1 oracle: within-chunk scans over the (NS, Cs, L) slab."""
    return torch.cumsum(_t(vals) * _t(x)[_idx(cols)], dim=-1)


def split_partial_ref(psum, piece_split, piece_chunk, piece_lo, piece_hi,
                      piece_row, num_splits: int, num_rows: int):
    """Carry fix-up into (NS, num_rows) per-split partial row sums (plus
    any trailing batch dims of ``psum``)."""
    psum = _t(psum)
    s, c, lo, hi, r = map(_idx, (piece_split, piece_chunk, piece_lo,
                                 piece_hi, piece_row))
    top = psum[s, c, hi]
    below = psum[s, c, (lo - 1).clamp(min=0)]
    keep = (lo > 0).reshape((-1,) + (1,) * (top.dim() - 1))
    contrib = top - torch.where(keep, below, torch.zeros_like(below))
    out = torch.zeros((num_splits * num_rows,) + tuple(psum.shape[3:]),
                      dtype=psum.dtype, device=psum.device)
    out.index_add_(0, s * num_rows + r, contrib)
    return out.reshape((num_splits, num_rows) + tuple(psum.shape[3:]))


def split_combine_ref(partial):
    """Stage-2 oracle: reduce the split axis, (NS, R, ...) -> (R, ...)."""
    return _t(partial).sum(0)


def split_spmv_ref(vals, cols, rows, x, num_rows: int):
    """End-to-end split oracle: the seg oracle on the flattened slab."""
    vals, cols, rows = _t(vals), _t(cols), _t(rows)
    NS, Cs, L = vals.shape
    return seg_spmv_ref(vals.reshape(NS * Cs, L), cols.reshape(NS * Cs, L),
                        rows.reshape(NS * Cs, L), x, num_rows)


def _block_rows(contrib, trows, num_rows: int, bm: int, tail):
    """Scatter-add (T, bm, ...) tile results into block rows, dropping
    tiles whose block row lies past the last one."""
    Mb = max(-(-num_rows // bm), 1)
    out = torch.zeros((Mb, bm) + tail, dtype=contrib.dtype,
                      device=contrib.device)
    trows = _idx(trows)
    keep = trows < Mb
    out.index_add_(0, trows[keep], contrib[keep])
    return out.reshape((Mb * bm,) + tail)[:num_rows]


def tile_spmv_ref(data, tile_rows, tile_cols, x, num_rows: int):
    """Bitmask-tiled oracle over the occupied-tile list: x padded to a
    ``bn`` multiple, one dense (bm, bn) product per tile, scatter-add into
    block rows.  x is (N,) or (N, B)."""
    data, x = _t(data), _t(x)
    T, bm, bn = data.shape
    n, tail = x.shape[0], tuple(x.shape[1:])
    Nb = max(-(-n // bn), 1)
    xp = torch.zeros((Nb * bn,) + tail, dtype=x.dtype, device=x.device)
    xp[:n] = x
    gathered = xp.reshape((Nb, bn) + tail)[_idx(tile_cols)]   # (T, bn[, B])
    contrib = torch.einsum("tij,tj...->ti...", data, gathered)
    return _block_rows(contrib, tile_rows, num_rows, bm, tail)


def tile_flat_spmv_ref(data, xcols, trows, x, num_rows: int):
    """Flat-gather variant: per-lane x positions ``xcols`` (T, bn); tiles
    with ``trows`` past the last block row drop."""
    data, x = _t(data), _t(x)
    gathered = x[_idx(xcols)]                                 # (T, bn[, B])
    contrib = torch.einsum("tij,tj...->ti...", data, gathered)
    return _block_rows(contrib, trows, num_rows, data.shape[1],
                       tuple(x.shape[1:]))


def bell_spmv_ref(blocks, bcols, x):
    """Block-ELL oracle: blocks (Mb, K, bm, bn), bcols (Mb, K), x
    (Nb * bn,) -> (Mb * bm,)."""
    blocks = _t(blocks)
    Mb, K, bm, bn = blocks.shape
    gathered = _t(x).reshape(-1, bn)[_idx(bcols)]             # (Mb, K, bn)
    return torch.einsum("mkij,mkj->mi", blocks, gathered).reshape(Mb * bm)


def bell_spmm_ref(blocks, bcols, X):
    """Block-ELL SpMM oracle: X (Nb * bn, B) -> (Mb * bm, B)."""
    blocks, X = _t(blocks), _t(X)
    Mb, K, bm, bn = blocks.shape
    gathered = X.reshape(-1, bn, X.shape[1])[_idx(bcols)]     # (Mb,K,bn,B)
    Y = torch.einsum("mkij,mkjb->mib", blocks, gathered)
    return Y.reshape(Mb * bm, X.shape[1])
