"""Split-nnz SpMV: stage 1's prefix sums over the split slab and stage
2's split-axis combine (``csrc/spmv_split.cu``), and the two fused after
the fix-up (:func:`split_fixup`, ``csrc/spmv_seg.cu``).

Counterpart of ``repro.kernels.spmv_split.split_psum`` and
``split_combine``.  Between them runs the carry fix-up,
:func:`~repro_torch.kernels.spmv_seg.seg_fixup` with ``num_splits=NS``.
The port's split paths (the executor, ``ops.split_spmv``) run neither
that fix-up nor :func:`split_combine`: :func:`split_fixup` is
``seg_fixup``'s kernel writing y, each row's runs folded in split order
as it meets them, bitwise the pair with no (n, B, NS, R) partials.
The executor's split shards take stage 1 from
:func:`~repro_torch.kernels.spmv_seg.seg_psum` on their flattened slab,
as the reference's device path does; the host op
``ops.split_spmv`` takes it from :func:`split_psum`, which launches
``seg_psum``'s kernel on the (1, NS*Cs, L) view of the slab with x as one
shared (1, n, B) buffer: its result is ``seg_psum``'s on that view,
bitwise.

    psum[b, s, c, l] = sum_{j <= l} vals[s, c, j] * x[cols[s, c, j], b]
    y[sids[k], b, r] = sum_t part[k, b, t, r]     (t = 0 .. NS-1, in order)
    split_fixup: the same y, the sum over the splits t that row r has
                 pieces in, each run summed in piece order from 0
"""
from __future__ import annotations

import torch

from . import _lib

__all__ = ["split_psum", "split_psum_plain", "split_combine",
           "split_combine_plain", "split_fixup", "split_fixup_plain"]


def split_psum_plain(vals, cols, x, out):
    """Gather, multiply and ``cumsum`` within each chunk."""
    out[:] = torch.cumsum(vals[None] * x[cols.long()].movedim(-1, 0), dim=-1)
    return out


def split_psum(vals, cols, x, *, out=None):
    """Per-chunk inclusive prefix sums over the (NS, Cs, L) slab for the
    vectors ``x`` (n, B); returns (B, NS, Cs, L).  A CUDA tensor launches
    the kernel; a CPU tensor runs :func:`split_psum_plain`."""
    NS, Cs, L = vals.shape
    B = x.shape[1]
    if out is None:
        out = torch.empty((B, NS, Cs, L), dtype=torch.float32,
                          device=vals.device)
    if vals.device.type == "cpu":
        return split_psum_plain(vals, cols, x, out)
    f32, i32 = torch.float32, torch.int32
    _lib.check(vals.device, vals=(vals, f32, 3), cols=(cols, i32, 3),
               x=(x, f32, 2), out=(out, f32, 4))
    if cols.shape != vals.shape or out.shape != (B, NS, Cs, L):
        raise ValueError("split_psum: operand shapes disagree")
    if L % 4 or L <= 0:
        raise ValueError(f"split_psum: chunk {L} must be a positive multiple "
                         f"of 4 (the kernel moves 4 elements a load)")
    if any(t.data_ptr() % 16 for t in (vals, cols, out)):
        raise ValueError("split_psum: vals, cols and out must be 16-byte "
                         "aligned (the kernel moves 4 elements a load)")
    if NS * Cs == 0 or B == 0:
        return out
    _lib.call("split_psum", "rt_split_psum", vals.device,
              vals.data_ptr(), cols.data_ptr(),
              x.data_ptr(), NS * Cs, L, B, out.data_ptr())
    return out


def split_combine_plain(part, sids, out):
    """The in-order sum over the split axis."""
    for k, sid in enumerate(sids.tolist()):
        acc = torch.zeros_like(part[k, :, 0])                   # (B, R)
        for t in range(part.shape[2]):
            acc = acc + part[k, :, t]
        out[sid] = acc
    return out


def split_combine(part, sids, *, out):
    """Reduce the (n, B, NS, R) partials into ``out`` (S, B, R)."""
    n, B, NS, R = part.shape
    if part.device.type == "cpu":
        return split_combine_plain(part, sids, out)
    f32 = torch.float32
    _lib.check(part.device, part=(part, f32, 4),
               sids=(sids, torch.int32, 1), out=(out, f32, 3))
    if sids.numel() != n or out.shape[1:] != (B, R):
        raise ValueError("split_combine: operand shapes disagree")
    if n == 0 or B == 0:
        return out
    _lib.call("split_combine", "rt_split_combine", part.device,
              part.data_ptr(), sids.data_ptr(), n, NS, R, B, out.data_ptr())
    return out


def split_fixup_plain(psum, pieces, piece_ptr, sids, num_splits, out):
    """Each run of a row's pieces in one split summed in piece order from
    0, then the row's runs in split order from 0 (``index_add_`` adds in
    index order); a row without pieces gets 0."""
    R = piece_ptr.shape[1] - 1
    for k, sid in enumerate(sids.tolist()):
        n = int(piece_ptr[sid, R])
        chunk, lo, hi, row, split = pieces[sid, :n].long().unbind(1)
        if num_splits == 1:
            split = torch.zeros_like(split)
        ps = psum[k]                                            # (B, C, L)
        zero = torch.zeros((), dtype=ps.dtype, device=ps.device)
        h = ps[:, chunk, hi]
        d = torch.where(lo > 0, h - ps[:, chunk, (lo - 1).clamp(min=0)], h)
        d = torch.where(lo > hi, zero, d)
        new = torch.ones(n, dtype=torch.bool, device=ps.device)
        new[1:] = (row[1:] != row[:-1]) | (split[1:] != split[:-1])
        runs = torch.zeros((ps.shape[0], int(new.sum())), dtype=ps.dtype,
                           device=ps.device)
        runs.index_add_(1, torch.cumsum(new, 0) - 1, d)
        acc = torch.zeros((ps.shape[0], R), dtype=ps.dtype, device=ps.device)
        out[sid] = acc.index_add_(1, row[new], runs)
    return out


def split_fixup(psum, pieces, piece_ptr, sids, *, num_splits: int, out):
    """The split family's carry fix-up and combine in one launch: each
    row's runs summed in split order into ``out`` (S, B, R), every row of
    the listed shards; bitwise ``seg_fixup(..., num_splits=NS)`` into
    partials, then :func:`split_combine`.  Counted as ``split_fixup``."""
    n, B, C, L = psum.shape
    S, Pp, _ = pieces.shape
    R = piece_ptr.shape[1] - 1
    if psum.device.type == "cpu":
        return split_fixup_plain(psum, pieces, piece_ptr, sids, num_splits,
                                 out)
    f32, i32 = torch.float32, torch.int32
    _lib.check(psum.device, psum=(psum, f32, 4), pieces=(pieces, i32, 3),
               piece_ptr=(piece_ptr, i32, 2), sids=(sids, i32, 1),
               out=(out, f32, 3))
    if pieces.shape[2] != 5 or piece_ptr.shape[0] != S \
            or sids.numel() != n or out.shape[1:] != (B, R):
        raise ValueError("split_fixup: operand shapes disagree")
    if n == 0 or B == 0:
        return out
    _lib.call("split_fixup", "rt_split_fixup", psum.device, psum.data_ptr(),
              pieces.data_ptr(), piece_ptr.data_ptr(), sids.data_ptr(), n, C,
              L, Pp, R, num_splits, B, out.data_ptr())
    return out
