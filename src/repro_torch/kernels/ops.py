"""Format builders (host, numpy), the per-format kernel API, and the
executor's S-stacked device ops.

Counterpart of ``repro.kernels.ops``.

* The builders are the reference's arithmetic exactly, so they produce
  bitwise-equal slabs.
* The per-format kernel API has the reference's names and arguments:
  one matrix in one format (:func:`seg_from_csr`, :func:`split_from_csr`,
  :func:`hyb_from_csr`, :func:`tile_from_csr`, or its raw arrays), and x
  of shape (N,) or (N, B).  Each op runs on ``device`` (default
  ``"cuda"``, which raises without a GPU): host arrays go to that device,
  CUDA tensors launch the port's kernels, CPU tensors run the kernels'
  plain PyTorch versions.  The TPU-only keywords (``use_kernel``,
  ``interpret``, ``tile_m``, ``tile_w``, ``tile_c``, ``tile_b``) are not
  carried over: the port has one execution path per device, and the
  ``*_ref`` functions (:mod:`repro_torch.kernels.ref`) are the oracles.
  Column b of an (N, B) call equals the call on ``x[:, b]`` bitwise.
* The stacked ops (``*_stacked``) run one kernel family over the listed
  shards of the S-stacked operands the executor builds: x is the
  batch-minor buffer (S or 1, Lx, B) and the result is written into
  ``out`` (S, B, R), rows of the listed shards only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.partition import nnz_chunk_starts
from ..core.sparse_matrix import ELL_LANE, ELL_SUBLANE, EllMatrix, \
    SegMatrix, SplitMatrix, TileMatrix, csr_row_nnz, csr_to_ell, \
    csr_to_tile, hyb_cap_width
from ..core.spmv import _warn_deprecated
# the oracles this module re-exports, as the reference's ops does
from .ref import bell_spmm_ref, bell_spmv_ref, ell_spmv_ref, seg_spmv_ref, \
    split_spmv_ref, tile_flat_spmv_ref, tile_spmv_ref
from .spmv_ell import ell_spmv as _ell_kernel
from .spmv_seg import seg_piece_fixup, seg_piece_sums, seg_psum
from .spmv_split import split_fixup, split_psum
from .spmv_tile import tile_contrib, tile_walk_spmv

__all__ = ["SEG_CHUNK", "resolve_device", "hyb_from_csr", "seg_from_csr",
           "split_from_csr", "tile_from_csr", "bell_from_bcsr",
           "ell_spmv", "hyb_spmv", "seg_spmv", "split_spmv",
           "split_flat_spmv", "tile_spmv", "tile_flat_spmv", "bell_spmv",
           "bell_spmm", "ell_spmv_ref", "seg_spmv_ref", "split_spmv_ref",
           "tile_spmv_ref", "ell_stacked", "hyb_stacked", "seg_stacked",
           "split_stacked", "split_scratch_bytes", "split_long_rows",
           "LONG_ROW", "tile_stacked"]

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


def bell_from_bcsr(bcsr) -> tuple[np.ndarray, np.ndarray]:
    """Deprecated: BcsrMatrix -> padded Block-ELL ``(blocks, bcols)``,
    K = the most blocks of a block row; padded slots hold zero blocks and
    block column 0.  Build a TileMatrix with :func:`tile_from_csr`
    instead."""
    _warn_deprecated("bell_from_bcsr", "repro_torch.kernels.ops.tile_from_csr")
    Mb = bcsr.block_row_ptr.shape[0] - 1
    bm, bn = bcsr.block_shape
    per_row = np.diff(bcsr.block_row_ptr)
    K = max(int(per_row.max()) if Mb else 1, 1)
    blocks = np.zeros((Mb, K, bm, bn), dtype=bcsr.blocks.dtype)
    bcols = np.zeros((Mb, K), dtype=np.int32)
    for r in range(Mb):
        lo, hi = int(bcsr.block_row_ptr[r]), int(bcsr.block_row_ptr[r + 1])
        blocks[r, : hi - lo] = bcsr.blocks[lo:hi]
        bcols[r, : hi - lo] = bcsr.block_cols[lo:hi]
    return blocks, bcols


# --------------------------------------------------------------------------
# the per-format kernel API (one matrix, x (N,) or (N, B))
# --------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU.  Raises where CUDA was asked for and is absent: nothing falls
    back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the kernels' plain PyTorch versions on the CPU")
    return dev


def _on(dev, a, dtype=torch.float32):
    return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()


def _idx(dev, a):
    return _on(dev, a, torch.int32)


def _x_in(dev, x):
    """x (N,) or (N, B) -> the kernels' batch-minor (N, B) buffer, and
    whether it was batched."""
    x = _on(dev, x)
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be (N,) or (N, B), got {tuple(x.shape)}")
    return (x, True) if x.dim() == 2 else (x[:, None], False)


def _y_out(y, batched: bool):
    """(B, R) -> (R, B) or (R,)."""
    return y.t().contiguous() if batched else y[0]


def _one(dev):
    return torch.zeros(1, dtype=torch.int32, device=dev)


def _ranges(sorted_ids, n: int):
    """(n+1,) int32 starts of ids 0..n in a sorted id tensor."""
    return torch.searchsorted(
        sorted_ids.long(), torch.arange(n + 1, device=sorted_ids.device)).int()


def _piece_table(dev, chunk, lo, hi, row, split, L: int, num_rows: int):
    """The kernels' piece table: (P, 5) [chunk, lo, hi, row, split] sorted
    by row, then by position in the nnz stream (so split-ordered within a
    row), and its (R+1,) row ranges."""
    pcs = torch.stack([_idx(dev, a) for a in (chunk, lo, hi, row, split)], 1)
    key = (pcs[:, 3].long() << 31) + pcs[:, 0].long() * L + pcs[:, 1].long()
    pcs = pcs[torch.argsort(key, stable=True)].contiguous()
    return pcs, _ranges(pcs[:, 3], num_rows)


def _device_form(fmt, cls, fields, num_rows, what: str, dev, build):
    """``build(arrays, num_rows)``: the device form (operands, piece table)
    of a format object or a raw tuple of its arrays.  A format object is
    frozen, so its form is built once per device and row count and kept on
    the object; a raw tuple is built anew on every call."""
    if not isinstance(fmt, cls):
        if num_rows is None:
            raise ValueError(f"num_rows is required with raw {what} arrays")
        return build(list(fmt), num_rows)
    num_rows = fmt.shape[0] if num_rows is None else num_rows
    forms = vars(fmt).setdefault("_device_forms", {})
    key = (str(dev), num_rows)
    if key not in forms:
        forms[key] = build([getattr(fmt, f) for f in fields], num_rows)
    return forms[key]


def _ell(dev, data, cols, ovf, x):
    """One matrix through the ELL/HYB kernel (S = 1); ``ovf`` is
    (rows, cols, vals), reordered by row for the kernel's ranges.  The
    caller's slab has no length table, so every slot counts as real."""
    data, cols = _on(dev, data), _idx(dev, cols)
    xb, batched = _x_in(dev, x)
    M = data.shape[0]
    orow, ocol, oval = _idx(dev, ovf[0]), _idx(dev, ovf[1]), _on(dev, ovf[2])
    order = torch.argsort(orow, stable=True)
    orow, ocol, oval = orow[order], ocol[order], oval[order]
    y = hyb_stacked(data[None], cols[None], orow[None], ocol[None],
                    oval[None], _ranges(orow, M)[None], xb[None], _one(dev))
    return _y_out(y[0], batched)


def ell_spmv(data, cols, x, *, device="cuda"):
    """Padded-ELL SpMV: ``y[i] = sum_w data[i, w] * x[cols[i, w]]`` over
    the (M, W) slab; returns (M,) or (M, B)."""
    empty = np.zeros(0, np.int32)
    return _ell(resolve_device(device), data, cols,
                (empty, empty, empty.astype(np.float32)), x)


def hyb_spmv(ell_data, ell_cols, ovf_rows, ovf_cols, ovf_vals, x, *,
             device="cuda"):
    """HYB: the padded-ELL product plus the COO overflow tail, added per
    row in stored order inside the same kernel."""
    return _ell(resolve_device(device), ell_data, ell_cols,
                (ovf_rows, ovf_cols, ovf_vals), x)


def seg_spmv(seg: "SegMatrix | tuple", x, *, num_rows: int | None = None,
             device="cuda"):
    """Nonzero-balanced segmented SpMV: each piece's sum from the per-chunk
    scan (``seg_piece_sums``), then the carry fix-up.  ``seg`` is a
    :class:`SegMatrix` or the tuple ``(vals, cols, rows, piece_chunk,
    piece_lo, piece_hi, piece_row)`` (then ``num_rows`` is required); its
    pieces run in chunk order, as ``seg_from_csr`` makes them."""
    dev = resolve_device(device)

    def build(arrays, num_rows):
        vals, cols = _on(dev, arrays[0]), _idx(dev, arrays[1])
        p_chunk, p_lo, p_hi, p_row = arrays[3:]
        pcs, ptr = _piece_table(
            dev, p_chunk, p_lo, p_hi, p_row,
            torch.zeros(len(p_row), dtype=torch.int32, device=dev),
            vals.shape[1], num_rows)
        if bool((pcs[1:, 0] < pcs[:-1, 0]).any()):
            raise ValueError("seg pieces must run in chunk order, row by "
                             "row, as seg_from_csr makes them")
        return vals, cols, pcs, ptr, _ranges(pcs[:, 0], vals.shape[0])
    vals, cols, pcs, ptr, chunk_ptr = _device_form(
        seg, SegMatrix, ("vals", "cols", "rows", "piece_chunk", "piece_lo",
                         "piece_hi", "piece_row"), num_rows, "seg", dev,
        build)
    xb, batched = _x_in(dev, x)
    y = seg_stacked(vals[None], cols[None], pcs[None], ptr[None], xb[None],
                    _one(dev), chunk_ptr=chunk_ptr[None])
    return _y_out(y[0], batched)


def split_spmv(spl: "SplitMatrix | tuple", x, *,
               num_rows: int | None = None, device="cuda"):
    """Split-nnz two-stage SpMV: ``split_psum`` over the (NS, Cs, L) slab,
    then the per-split carry fix-up and combine in one launch
    (``split_fixup``).  ``spl`` is a
    :class:`SplitMatrix` or the tuple ``(vals, cols, rows, piece_split,
    piece_chunk, piece_lo, piece_hi, piece_row)`` (then ``num_rows`` is
    required)."""
    dev = resolve_device(device)

    def build(arrays, num_rows):
        vals, cols = _on(dev, arrays[0]), _idx(dev, arrays[1])
        _, Cs, L = vals.shape
        p_split, p_chunk, p_lo, p_hi, p_row = (_idx(dev, a)
                                               for a in arrays[3:])
        return (vals, cols) + _piece_table(
            dev, p_split * Cs + p_chunk, p_lo, p_hi, p_row, p_split, L,
            num_rows)
    vals, cols, pcs, ptr = _device_form(
        spl, SplitMatrix, ("vals", "cols", "rows", "piece_split",
                           "piece_chunk", "piece_lo", "piece_hi",
                           "piece_row"), num_rows, "split", dev, build)
    NS, Cs, L = vals.shape
    xb, batched = _x_in(dev, x)
    psum = split_psum(vals, cols, xb)                     # (B, NS, Cs, L)
    y = _split_fixup_combine(psum.view(1, -1, NS * Cs, L), pcs[None],
                             ptr[None], _one(dev), NS, None)
    return _y_out(y[0], batched)


def split_flat_spmv(vals, cols, rows, pieces, x, *, num_rows: int,
                    num_splits: int, device="cuda"):
    """Split SpMV over the flattened (NS*Cs, L) slab and its (P, 5) piece
    table ``[flat_chunk, lo, hi, row, split]`` (padded rows
    ``[0, 1, 0, 0, 0]`` add nothing): ``seg_psum``, then the per-split
    fix-up and the split combine in one launch.  ``rows`` is the oracle's
    operand only."""
    dev = resolve_device(device)
    vals, cols = _on(dev, vals), _idx(dev, cols)
    pieces = _idx(dev, pieces).reshape(-1, 5)
    pcs, ptr = _piece_table(dev, *pieces.unbind(1), vals.shape[1], num_rows)
    xb, batched = _x_in(dev, x)
    y = split_stacked(vals[None], cols[None], pcs[None], ptr[None], xb[None],
                      _one(dev), num_splits=num_splits)
    return _y_out(y[0], batched)


def tile_spmv(tile: TileMatrix, x, *, num_rows: int | None = None,
              device="cuda"):
    """Bitmask-tiled SpMV: the walk over each block row's occupied tiles
    (``tile_walk_spmv``), x addressed by block column; the kernel reads
    only the cells ``tile.mask`` marks."""
    dev = resolve_device(device)
    num_rows = tile.shape[0] if num_rows is None else num_rows
    data, tcols, tptr, mask = _device_form(
        tile, TileMatrix, ("data", "tile_cols", "tile_ptr", "mask"), None,
        "tile", dev, lambda a, _: (_on(dev, a[0]), _idx(dev, a[1]),
                                   _idx(dev, a[2]),
                                   _on(dev, a[3], torch.uint8)))
    xb, batched = _x_in(dev, x)
    y = tile_walk_spmv(data, tcols, tptr, xb, mask=mask)
    return _y_out(y[:, :num_rows], batched)


def tile_flat_spmv(data, xcols, trows, x, *, num_rows: int, device="cuda"):
    """Tile SpMV over the flat pre-gathered operands: per-lane x positions
    ``xcols`` (T, bn) and block rows ``trows`` (T,); tiles past the last
    block row drop.  Lane gather, products and block-row sums run in one
    kernel (``tile_contrib``), which walks tiles sorted by block row."""
    dev = resolve_device(device)
    data, xcols, trows = _on(dev, data), _idx(dev, xcols), _idx(dev, trows)
    bm = data.shape[1]
    Rb = max(-(-num_rows // bm), 1)
    if len(trows) > 1 and bool((trows[1:] < trows[:-1]).any()):
        order = torch.argsort(trows, stable=True)
        data, xcols, trows = data[order], xcols[order], trows[order]
    xb, batched = _x_in(dev, x)
    y = tile_stacked(data[None], xcols[None], trows[None],
                     _ranges(trows, Rb)[None], xb[None], _one(dev))
    return _y_out(y[0, :, :num_rows], batched)


def _bell_walk(blocks, bcols, x, dev):
    """Block-ELL as the tile walk: slot (mb, k) is tile mb*K + k.  The slab
    has no mask, so every cell is read."""
    blocks = _on(dev, blocks)
    Mb, K, bm, bn = blocks.shape
    ptr = torch.arange(Mb + 1, dtype=torch.int32, device=dev) * K
    xb, batched = _x_in(dev, x)
    y = tile_walk_spmv(blocks.reshape(Mb * K, bm, bn),
                       _idx(dev, bcols).reshape(-1), ptr, xb)
    return _y_out(y, batched)


def bell_spmv(blocks, bcols, x, *, device="cuda"):
    """Deprecated Block-ELL SpMV, run as the tile walk; use
    :func:`tile_spmv` on a :func:`tile_from_csr` matrix instead."""
    _warn_deprecated("bell_spmv", "repro_torch.kernels.ops.tile_spmv")
    return _bell_walk(blocks, bcols, x, resolve_device(device))


def bell_spmm(blocks, bcols, X, *, device="cuda"):
    """Deprecated Block-ELL SpMM (X is (N, B)), run as the tile walk; use
    :func:`tile_spmv` with an (N, B) block instead."""
    _warn_deprecated("bell_spmm", "repro_torch.kernels.ops.tile_spmv")
    return _bell_walk(blocks, bcols, X, resolve_device(device))


# --------------------------------------------------------------------------
# the executor's stacked ops (one kernel family over the listed shards)
# --------------------------------------------------------------------------

def _out(out, like, S: int, B: int, R: int):
    if out is not None:
        return out
    return torch.empty((S, B, R), dtype=torch.float32, device=like.device)


def hyb_stacked(data, cols, ovf_rows, ovf_cols, ovf_vals, ovf_ptr, x, sids,
                *, ell_len=None, out=None):
    """ELL slab + the COO overflow tail, fused in one kernel; ``ell_len``
    (S, R) bounds each row's real slots (None: every slot)."""
    return _ell_kernel(data, cols, ovf_rows, ovf_cols, ovf_vals, ovf_ptr, x,
                       sids, ell_len=ell_len, out=out)


def ell_stacked(data, cols, x, sids, *, ell_len=None, out=None):
    """Padded-ELL SpMV (no overflow tail)."""
    S, R, _ = data.shape
    z = torch.zeros((S, 1), dtype=torch.int32, device=data.device)
    ptr = torch.zeros((S, R + 1), dtype=torch.int32, device=data.device)
    return _ell_kernel(data, cols, z, z, z.float(), ptr, x, sids,
                       ell_len=ell_len, out=out)


def _split_fixup_combine(psum, pieces, piece_ptr, sids, num_splits: int,
                         out):
    """The split carry fix-up and combine in one launch: each row's runs
    summed in split order into ``out`` (S, B, R), no per-split partials."""
    out = _out(out, psum, piece_ptr.shape[0], psum.shape[1],
               piece_ptr.shape[1] - 1)
    return split_fixup(psum, pieces, piece_ptr, sids, num_splits=num_splits,
                       out=out)


def _chunk_ranges(pieces, piece_ptr, num_chunks: int):
    """(S, C+1) int32: each chunk's range of its shard's real pieces
    (those below ``piece_ptr[:, R]``), which must run in chunk order."""
    S, Pp, _ = pieces.shape
    real = torch.arange(Pp, device=pieces.device)[None] \
        < piece_ptr[:, -1:].long()
    key = torch.where(real, pieces[:, :, 0].long(), num_chunks)
    at = torch.arange(num_chunks + 1, device=pieces.device)
    return torch.searchsorted(key.contiguous(),
                              at.expand(S, -1).contiguous()).int()


def seg_stacked(vals, cols, pieces, piece_ptr, x, sids, *, chunk_ptr=None,
                out=None):
    """Segmented SpMV: each piece's sum from the per-chunk scan, then the
    carry fix-up over them.  ``chunk_ptr`` (S, C+1) is each chunk's range
    of the shard's pieces (the executor's ``seg_chunk_ptr``); without it
    :func:`_chunk_ranges` builds it from the table."""
    if chunk_ptr is None:
        chunk_ptr = _chunk_ranges(pieces, piece_ptr, vals.shape[1])
    out = _out(out, vals, vals.shape[0], x.shape[2], piece_ptr.shape[1] - 1)
    d = seg_piece_sums(vals, cols, x, pieces, chunk_ptr, sids)
    return seg_piece_fixup(d, piece_ptr, sids, out=out)


def split_stacked(vals, cols, pieces, piece_ptr, x, sids, *,
                  num_splits: int, out=None):
    """Split SpMV over the flattened (NS*Cs, L) slab: seg_psum, then the
    per-split fix-up and the split combine in one launch."""
    psum = seg_psum(vals, cols, x, sids)
    return _split_fixup_combine(psum, pieces, piece_ptr, sids, num_splits,
                                out)


def split_scratch_bytes(vals, n: int, B: int) -> int:
    """Bytes of device scratch one :func:`split_stacked` call over ``n``
    shards and B columns allocates: seg_psum's (n, B, C, L) running sums,
    float32 (the fix-up writes y)."""
    return 4 * n * B * vals.shape[1] * vals.shape[2]


#: The most pieces a row may have for one lane of the carry fix-up to walk
#: it; longer rows go to the block's warps (``LONG_ROW`` in
#: ``csrc/spmv_seg.cu``).
LONG_ROW = 2


def split_long_rows(pieces, piece_ptr, num_splits: int) -> dict:
    """What the split fix-up's long-row path takes in one launch over the
    shards whose host tables are given, ``pieces`` (n, Pp, 5) and
    ``piece_ptr`` (n, R+1): ``long_rows``, the rows of more than
    :data:`LONG_ROW` pieces; ``long_pieces``, their pieces; ``long_runs``,
    their runs (a change of split starts one; at one split a row is one
    run).  ``long_pieces / long_runs`` is the mean serial chain of adds
    the path leaves a run."""
    rows = n_pieces = runs = 0
    for pcs, ptr in zip(pieces, piece_ptr):
        count = np.diff(ptr)
        long = count > LONG_ROW
        row = np.repeat(np.arange(count.size), count)
        split = pcs[ptr[0]:ptr[-1], 4] if num_splits > 1 else \
            np.zeros(row.size, dtype=np.int32)
        new = np.ones(row.size, dtype=bool)
        new[1:] = (row[1:] != row[:-1]) | (split[1:] != split[:-1])
        rows += int(long.sum())
        n_pieces += int(count[long].sum())
        runs += int(new[long[row]].sum())
    return {"long_rows": rows, "long_pieces": n_pieces, "long_runs": runs}


def tile_stacked(data, xcol, brow, tile_ptr, x, sids, *, rb_used=None,
                 out=None):
    """Tile SpMV: lane gather, per-tile products and block-row sums in one
    kernel, walking the block rows below ``rb_used`` (None: all)."""
    return tile_contrib(data, xcol, brow, tile_ptr, x, sids, rb_used=rb_used,
                        out=out)
