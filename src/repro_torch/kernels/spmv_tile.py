"""Bitmask-tiled SpMV over the flat device operands (``csrc/spmv_tile.cu``).

Counterpart of ``repro.kernels.spmv_tile.tile_contrib`` together with the
jnp lane gather and block-row scatter around it on the device path:

    y[s, b, mb*bm + i] = sum over block row mb's tiles t of
                         sum_j data[s, t, i, j] * x[s, b, xcol[s, t, j]]

Tiles are sorted by block row (``brow``); padding tiles carry
``brow = Rb`` and drop.  ``tile_ptr`` (S, Rb+1) holds each block row's
run of tiles.
"""
from __future__ import annotations

import torch

from . import _lib

__all__ = ["tile_contrib", "tile_contrib_plain"]


def tile_contrib_plain(data, xcol, brow, x, sids, out):
    """Gather x lanes, per-tile row products, then the block-row sums in
    tile order with the padding tiles masked out."""
    S, Tp, bm, bn = data.shape
    Rb = out.shape[2] // bm
    for sid in sids.tolist():
        xs = x[sid if x.shape[0] > 1 else 0]                    # (B, Lx)
        xg = xs[:, xcol[sid].long()]                            # (B, Tp, bn)
        contrib = (data[sid][None] * xg[:, :, None, :]).sum(-1)  # (B,Tp,bm)
        keep = brow[sid] < Rb
        acc = torch.zeros((xs.shape[0], Rb, bm), dtype=data.dtype,
                          device=data.device)
        acc.index_add_(1, brow[sid][keep].long(), contrib[:, keep])
        out[sid] = acc.reshape(xs.shape[0], Rb * bm)
    return out


def tile_contrib(data, xcol, brow, tile_ptr, x, sids, *, out=None):
    """Tile SpMV over the shards ``sids``; returns ``out`` (S, B, R) with
    R = Rb * bm.  A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`tile_contrib_plain`."""
    S, Tp, bm, bn = data.shape
    B, Lx = x.shape[1], x.shape[2]
    Rb = tile_ptr.shape[1] - 1
    if out is None:
        out = torch.empty((S, B, Rb * bm), dtype=torch.float32,
                          device=data.device)
    if data.device.type == "cpu":
        return tile_contrib_plain(data, xcol, brow, x, sids, out)
    f32, i32 = torch.float32, torch.int32
    _lib.check(data.device, data=(data, f32, 4), xcol=(xcol, i32, 3),
               tile_ptr=(tile_ptr, i32, 2), x=(x, f32, 3),
               sids=(sids, i32, 1), out=(out, f32, 3))
    if (bm, bn) != (8, 128):
        raise ValueError(f"tile_contrib: the kernel takes (8, 128) tiles, "
                         f"got {(bm, bn)}")
    if xcol.shape != (S, Tp, bn) or tile_ptr.shape[0] != S \
            or out.shape != (S, B, Rb * bm) or x.shape[0] not in (1, S):
        raise ValueError("tile_contrib: operand shapes disagree")
    if sids.numel() == 0 or B == 0:
        return out
    _lib.call("tile_contrib", "rt_tile_spmv", data.data_ptr(),
              xcol.data_ptr(), tile_ptr.data_ptr(), x.data_ptr(),
              _lib.x_stride(x), sids.data_ptr(), sids.numel(), Tp, Rb, bm, bn,
              Lx, B, out.data_ptr())
    return out
