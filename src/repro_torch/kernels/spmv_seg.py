"""Segmented SpMV: per-chunk prefix sums and the carry fix-up
(``csrc/spmv_seg.cu``).

Counterpart of ``repro.kernels.spmv_seg.seg_psum`` (the TPU kernel) and
of the jnp fix-ups ``repro.kernels.ops._seg_fixup`` /
``_split_flat_fixup``.

* :func:`seg_psum` — ``psum[k, b, c, l]``, the inclusive prefix sum of
  ``vals * x[cols, b]`` inside chunk c of shard ``sids[k]``; (n, B, C, L).
  ``x`` is the batch-minor buffer (S or 1, Lx, B).
* :func:`seg_fixup` — each piece ``[chunk, lo, hi, row, split]`` adds
  ``psum[chunk, hi] - psum[chunk, lo-1]`` to ``out[out_ids[k], b, split,
  row]``, in piece order; rows without pieces get 0.  ``piece_ptr``
  (S, R+1) holds each row's range of the shard's real (row-ordered)
  pieces.  With ``num_splits=1`` ``out`` is y (S, B, R); with NS > 1 it
  is the split partials (n, B, NS, R).
* :func:`seg_piece_sums` — the seg family's scan: ``d[k, b, p]``, piece
  p's ``psum[chunk, hi] - psum[chunk, lo-1]`` straight from the scan,
  (n, B, Pp); ``psum`` never reaches device memory.  ``chunk_ptr``
  (S, C+1) holds each chunk's range of the shard's real pieces, which in
  a seg shard run in chunk order (not so in a split shard, whose family
  keeps :func:`seg_psum` and :func:`seg_fixup`).
* :func:`seg_piece_fixup` — :func:`seg_fixup`'s kernel with NS = 1 over
  ``d``: each row's pieces ``[piece_ptr[r], piece_ptr[r+1])`` summed in
  order from 0 into y (S, B, R); counted under ``seg_fixup``.

The pair equals :func:`seg_psum` then :func:`seg_fixup` (NS = 1)
bitwise, on the card and in the plain versions.
"""
from __future__ import annotations

import torch

from . import _lib

__all__ = ["seg_psum", "seg_psum_plain", "seg_fixup", "seg_fixup_plain",
           "seg_piece_sums", "seg_piece_sums_plain", "seg_piece_fixup",
           "seg_piece_fixup_plain"]


def seg_psum_plain(vals, cols, x, sids, out):
    """Gather, multiply and ``cumsum`` within each chunk."""
    for k, sid in enumerate(sids.tolist()):
        xs = x[sid if x.shape[0] > 1 else 0]                    # (Lx, B)
        xg = xs[cols[sid].long()].movedim(-1, 0)                # (B, C, L)
        out[k] = torch.cumsum(vals[sid] * xg, dim=-1)
    return out


def seg_psum(vals, cols, x, sids, *, out=None):
    """Per-chunk inclusive prefix sums; returns (n, B, C, L)."""
    S, C, L = vals.shape
    B = x.shape[2]
    n = sids.numel()
    if out is None:
        out = torch.empty((n, B, C, L), dtype=torch.float32,
                          device=vals.device)
    if vals.device.type == "cpu":
        return seg_psum_plain(vals, cols, x, sids, out)
    f32, i32 = torch.float32, torch.int32
    _lib.check(vals.device, vals=(vals, f32, 3), cols=(cols, i32, 3),
               x=(x, f32, 3), sids=(sids, i32, 1), out=(out, f32, 4))
    if cols.shape != vals.shape or out.shape != (n, B, C, L) \
            or x.shape[0] not in (1, S):
        raise ValueError("seg_psum: operand shapes disagree")
    if L % 4 or L <= 0:
        raise ValueError(f"seg_psum: chunk {L} must be a positive multiple "
                         f"of 4 (the kernel moves 4 elements a load)")
    if any(t.data_ptr() % 16 for t in (vals, cols, out)):
        raise ValueError("seg_psum: vals, cols and out must be 16-byte "
                         "aligned (the kernel moves 4 elements a load)")
    if n == 0 or B == 0:
        return out
    _lib.call("seg_psum", "rt_seg_psum", vals.device,
              vals.data_ptr(), cols.data_ptr(),
              x.data_ptr(), _lib.x_stride(x), sids.data_ptr(), n, C, L, B,
              out.data_ptr())
    return out


def seg_fixup_plain(psum, pieces, piece_ptr, sids, out_ids, out):
    """Prefix differences per piece, added in piece order into zeros."""
    R = piece_ptr.shape[1] - 1
    NS = out.shape[2] if out.dim() == 4 else 1
    for k, (sid, o) in enumerate(zip(sids.tolist(), out_ids.tolist())):
        n = int(piece_ptr[sid, R])
        pc = pieces[sid, :n].long()
        chunk, lo, hi, row, split = pc.unbind(1)
        ps = psum[k]                                            # (B, C, L)
        hi_v = ps[:, chunk, hi]
        lo_v = torch.where(lo > 0, ps[:, chunk, (lo - 1).clamp(min=0)],
                           torch.zeros((), dtype=ps.dtype, device=ps.device))
        acc = torch.zeros((ps.shape[0], NS * R), dtype=ps.dtype,
                          device=ps.device)
        acc.index_add_(1, split * R + row, hi_v - lo_v)
        out[o] = acc.reshape(out[o].shape)
    return out


def seg_fixup(psum, pieces, piece_ptr, sids, out_ids, *, num_splits: int,
              out):
    """The carry fix-up into ``out`` (see the module docstring)."""
    n, B, C, L = psum.shape
    S, Pp, _ = pieces.shape
    R = piece_ptr.shape[1] - 1
    if psum.device.type == "cpu":
        return seg_fixup_plain(psum, pieces, piece_ptr, sids, out_ids, out)
    f32, i32 = torch.float32, torch.int32
    _lib.check(psum.device, psum=(psum, f32, 4), pieces=(pieces, i32, 3),
               piece_ptr=(piece_ptr, i32, 2), sids=(sids, i32, 1),
               out_ids=(out_ids, i32, 1), out=(out, f32, out.dim()))
    per_out = num_splits * R * B
    if pieces.shape[2] != 5 or piece_ptr.shape[0] != S \
            or sids.numel() != n or out_ids.numel() != n \
            or out.numel() % per_out or out.shape[-1] != R:
        raise ValueError("seg_fixup: operand shapes disagree")
    if n == 0 or B == 0:
        return out
    _lib.call("seg_fixup", "rt_seg_fixup", psum.device,
              psum.data_ptr(),
              pieces.data_ptr(), piece_ptr.data_ptr(), sids.data_ptr(),
              out_ids.data_ptr(), n, C, L, Pp, R, num_splits, B,
              out.data_ptr())
    return out


def seg_piece_sums_plain(vals, cols, x, pieces, chunk_ptr, sids, out):
    """:func:`seg_psum_plain`'s sums, differenced at each piece's ends;
    writes each shard's pieces ``[chunk_ptr[0], chunk_ptr[C])`` only."""
    B, C, L = x.shape[2], vals.shape[1], vals.shape[2]
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    for k, sid in enumerate(sids.tolist()):
        ps = seg_psum_plain(vals, cols, x, sids[k:k + 1],
                            torch.empty((1, B, C, L), dtype=out.dtype,
                                        device=out.device))[0]
        p0, p1 = int(chunk_ptr[sid, 0]), int(chunk_ptr[sid, C])
        chunk, lo, hi = pieces[sid, p0:p1, :3].long().unbind(1)
        h = ps[:, chunk, hi]
        diff = torch.where(lo > 0, h - ps[:, chunk, (lo - 1).clamp(min=0)], h)
        out[k, :, p0:p1] = torch.where(lo > hi, zero, diff)
    return out


def seg_piece_sums(vals, cols, x, pieces, chunk_ptr, sids, *, out=None):
    """Each piece's prefix difference from the per-chunk scan; returns
    (n, B, Pp), written at each shard's real pieces only."""
    S, C, L = vals.shape
    B = x.shape[2]
    n, Pp = sids.numel(), pieces.shape[1]
    if out is None:
        out = torch.empty((n, B, Pp), dtype=torch.float32,
                          device=vals.device)
    if vals.device.type == "cpu":
        return seg_piece_sums_plain(vals, cols, x, pieces, chunk_ptr, sids,
                                    out)
    f32, i32 = torch.float32, torch.int32
    _lib.check(vals.device, vals=(vals, f32, 3), cols=(cols, i32, 3),
               x=(x, f32, 3), pieces=(pieces, i32, 3),
               chunk_ptr=(chunk_ptr, i32, 2), sids=(sids, i32, 1),
               out=(out, f32, 3))
    if cols.shape != vals.shape or pieces.shape != (S, Pp, 5) \
            or chunk_ptr.shape != (S, C + 1) or out.shape != (n, B, Pp) \
            or x.shape[0] not in (1, S):
        raise ValueError("seg_piece_sums: operand shapes disagree")
    if L % 4 or L <= 0:
        raise ValueError(f"seg_piece_sums: chunk {L} must be a positive "
                         f"multiple of 4 (the kernel moves 4 elements a "
                         f"load)")
    if any(t.data_ptr() % 16 for t in (vals, cols)):
        raise ValueError("seg_piece_sums: vals and cols must be 16-byte "
                         "aligned (the kernel moves 4 elements a load)")
    if n == 0 or B == 0:
        return out
    _lib.call("seg_piece_sums", "rt_seg_piece_sums", vals.device,
              vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
              _lib.x_stride(x), pieces.data_ptr(), chunk_ptr.data_ptr(),
              sids.data_ptr(), n, C, L, Pp, B, out.data_ptr())
    return out


def seg_piece_fixup_plain(d, piece_ptr, sids, out):
    """Each row's piece differences, added in piece order into zeros."""
    R = piece_ptr.shape[1] - 1
    rows = torch.arange(R, device=d.device)
    for k, sid in enumerate(sids.tolist()):
        ptr = piece_ptr[sid].long()
        acc = torch.zeros((d.shape[1], R), dtype=d.dtype, device=d.device)
        acc.index_add_(1, torch.repeat_interleave(rows, ptr.diff()),
                       d[k, :, int(ptr[0]):int(ptr[R])])
        out[sid] = acc
    return out


def seg_piece_fixup(d, piece_ptr, sids, *, out):
    """The seg family's carry fix-up over :func:`seg_piece_sums`' d into
    y (S, B, R), the listed shards' rows."""
    n, B, Pp = d.shape
    R = piece_ptr.shape[1] - 1
    if d.device.type == "cpu":
        return seg_piece_fixup_plain(d, piece_ptr, sids, out)
    f32, i32 = torch.float32, torch.int32
    _lib.check(d.device, d=(d, f32, 3), piece_ptr=(piece_ptr, i32, 2),
               sids=(sids, i32, 1), out=(out, f32, 3))
    if sids.numel() != n or out.shape[1:] != (B, R) \
            or piece_ptr.shape[0] != out.shape[0]:
        raise ValueError("seg_piece_fixup: operand shapes disagree")
    if n == 0 or B == 0:
        return out
    _lib.call("seg_fixup", "rt_seg_piece_fixup", d.device, d.data_ptr(),
              piece_ptr.data_ptr(), sids.data_ptr(), n, Pp, R, B,
              out.data_ptr())
    return out
