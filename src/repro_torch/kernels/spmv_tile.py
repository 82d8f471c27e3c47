"""Bitmask-tiled SpMV: the walk over each block row's occupied tiles
(``csrc/spmv_tile.cu``).

* :func:`tile_contrib` — counterpart of
  ``repro.kernels.spmv_tile.tile_contrib`` together with the jnp lane
  gather and block-row scatter around it on the device path, over the
  executor's flat S-stacked operands::

      y[s, b, mb*bm + i] = sum over block row mb's tiles t of
                           sum_j data[s, t, i, j] * x[s, xcol[s, t, j], b]

  with ``x`` the batch-minor buffer (S or 1, Lx, B).

  Tiles are sorted by block row (``brow``); padding tiles carry
  ``brow = Rb`` and drop.  ``tile_ptr`` (S, Rb+1) holds each block row's
  run of tiles.  ``rb_used`` bounds the block rows the kernel walks: tiles
  at block rows from it on drop as padding tiles do, and their rows are
  zeros (the executor passes the last block row holding any of the
  shards' tiles, plus one; the launch then has warps only there, and
  zeroes the rows past them itself).
* :func:`tile_walk_spmv` — counterpart of
  ``repro.kernels.spmv_tile.tile_walk_spmv`` on one
  :class:`~repro_torch.core.sparse_matrix.TileMatrix`, x addressed by
  block column::

      y[b, mb*bm + i] = sum over t in tile_ptr[mb] .. tile_ptr[mb+1] of
                        sum_j data[t, i, j] * x[tile_cols[t]*bn + j, b]

  with x taken as 0 past its end.  The TPU kernel's K-padded walk tables
  and masked slots have no counterpart: the kernel walks ``tile_ptr``.
  ``mask`` (T, bm, bn/8) is the TileMatrix's packed occupancy: the kernel
  reads only the cells it marks (``mask=None``: every cell).  The plain
  version multiplies whole tiles and ignores ``mask``, so the card's check
  of the kernel against it also checks that the skipped cells held
  nothing.

Both take any tile shape: (8, 128) tiles (``tile_contrib``) and (8k, 128)
tiles (``tile_walk_spmv``) run the fast walks, every other shape a general
walk that reads what the fast ones read (the masked walk a tile row's mask
bytes in one aligned load, then its marked cells; the others every cell,
16 bytes a load where bn % 4 == 0), with every lane of a warp busy at
power-of-two shapes.
"""
from __future__ import annotations

import torch

from . import _lib

__all__ = ["tile_contrib", "tile_contrib_plain", "tile_walk_spmv",
           "tile_walk_spmv_plain"]


def tile_contrib_plain(data, xcol, brow, x, sids, out, rb_used=None):
    """Gather x lanes, per-tile row products, then the block-row sums in
    tile order with the tiles at block rows from ``rb_used`` (padding
    tiles included) masked out."""
    S, Tp, bm, bn = data.shape
    Rb = out.shape[2] // bm
    rb = Rb if rb_used is None else rb_used
    for sid in sids.tolist():
        xs = x[sid if x.shape[0] > 1 else 0].t().contiguous()   # (B, Lx)
        xg = xs[:, xcol[sid].long()]                            # (B, Tp, bn)
        contrib = (data[sid][None] * xg[:, :, None, :]).sum(-1)  # (B,Tp,bm)
        keep = brow[sid] < rb
        acc = torch.zeros((xs.shape[0], Rb, bm), dtype=data.dtype,
                          device=data.device)
        acc.index_add_(1, brow[sid][keep].long(), contrib[:, keep])
        out[sid] = acc.reshape(xs.shape[0], Rb * bm)
    return out


def tile_contrib(data, xcol, brow, tile_ptr, x, sids, *, rb_used=None,
                 out=None):
    """Tile SpMV over the shards ``sids``; returns ``out`` (S, B, R) with
    R = Rb * bm.  ``rb_used`` (None: Rb) bounds the block rows walked.  A
    CUDA tensor launches the kernel; a CPU tensor runs
    :func:`tile_contrib_plain`."""
    S, Tp, bm, bn = data.shape
    B = x.shape[2]
    Rb = tile_ptr.shape[1] - 1
    rb = Rb if rb_used is None else int(rb_used)
    if not 0 <= rb <= Rb:
        raise ValueError(f"tile_contrib: rb_used {rb} outside 0 .. {Rb}")
    if out is None:
        out = torch.empty((S, B, Rb * bm), dtype=torch.float32,
                          device=data.device)
    if data.device.type == "cpu":
        return tile_contrib_plain(data, xcol, brow, x, sids, out, rb)
    f32, i32 = torch.float32, torch.int32
    _lib.check(data.device, data=(data, f32, 4), xcol=(xcol, i32, 3),
               tile_ptr=(tile_ptr, i32, 2), x=(x, f32, 3),
               sids=(sids, i32, 1), out=(out, f32, 3))
    if bm < 1 or bn < 1:
        raise ValueError(f"tile_contrib: empty tile shape {(bm, bn)}")
    if xcol.shape != (S, Tp, bn) or tile_ptr.shape[0] != S \
            or out.shape != (S, B, Rb * bm) or x.shape[0] not in (1, S):
        raise ValueError("tile_contrib: operand shapes disagree")
    if any(t.data_ptr() % 16 for t in (data, xcol, out)):
        raise ValueError("tile_contrib: data, xcol and out must be 16-byte "
                         "aligned (the kernel moves 4 elements a load)")
    if sids.numel() == 0 or B == 0:
        return out
    _lib.call("tile_contrib", "rt_tile_spmv", data.device,
              data.data_ptr(),
              xcol.data_ptr(), tile_ptr.data_ptr(), x.data_ptr(),
              _lib.x_stride(x), sids.data_ptr(), sids.numel(), Tp, Rb, rb,
              bm, bn, B, out.data_ptr())
    return out


def tile_walk_spmv_plain(data, tile_cols, tile_ptr, x, out, mask=None):
    """Gather each tile's x block (x zero-padded to whole blocks), form the
    (bm, bn) @ (bn,) products of whole tiles, and sum them per block row
    in tile order.  ``mask`` is taken and ignored."""
    T, bm, bn = data.shape
    n, B = x.shape
    x = x.t().contiguous()                                      # (B, n)
    Mb = tile_ptr.numel() - 1
    Nb = max(-(-n // bn), 1)
    xb = torch.nn.functional.pad(x, (0, Nb * bn - n)).reshape(B, Nb, bn)
    xg = xb[:, tile_cols.long()]                                # (B, T, bn)
    contrib = (data[None] * xg[:, :, None, :]).sum(-1)          # (B, T, bm)
    brow = torch.repeat_interleave(
        torch.arange(Mb, device=data.device), torch.diff(tile_ptr.long()))
    acc = torch.zeros((B, Mb, bm), dtype=data.dtype, device=data.device)
    acc.index_add_(1, brow, contrib)
    out[:] = acc.reshape(B, Mb * bm)
    return out


def tile_walk_spmv(data, tile_cols, tile_ptr, x, *, mask=None, out=None):
    """The tile walk for the vectors ``x`` (n, B); returns ``out``
    (B, Mb*bm).  A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`tile_walk_spmv_plain`."""
    T, bm, bn = data.shape
    n, B = x.shape
    Mb = tile_ptr.numel() - 1
    if out is None:
        out = torch.empty((B, Mb * bm), dtype=torch.float32,
                          device=data.device)
    if data.device.type == "cpu":
        return tile_walk_spmv_plain(data, tile_cols, tile_ptr, x, out, mask)
    f32, i32 = torch.float32, torch.int32
    _lib.check(data.device, data=(data, f32, 3),
               tile_cols=(tile_cols, i32, 1), tile_ptr=(tile_ptr, i32, 1),
               x=(x, f32, 2), out=(out, f32, 2))
    if mask is not None:
        _lib.check(data.device, mask=(mask, torch.uint8, 3))
    if bm < 1 or bn < 1 or (mask is not None and bn % 8):
        raise ValueError(f"tile_walk_spmv: tile shape {(bm, bn)} must be "
                         f"non-empty, with bn a multiple of 8 with a mask")
    if tile_cols.numel() != T or out.shape != (B, Mb * bm) \
            or (mask is not None and mask.shape != (T, bm, bn // 8)):
        raise ValueError("tile_walk_spmv: operand shapes disagree")
    if data.data_ptr() % 16 or (mask is not None and mask.data_ptr() % 16):
        raise ValueError("tile_walk_spmv: data and mask must be 16-byte "
                         "aligned")
    if Mb == 0 or B == 0:
        return out
    _lib.call("tile_walk_spmv", "rt_tile_walk_spmv", data.device,
              data.data_ptr(), None if mask is None else mask.data_ptr(),
              tile_cols.data_ptr(), tile_ptr.data_ptr(), x.data_ptr(), Mb, bm,
              bn, n, B, out.data_ptr())
    return out
