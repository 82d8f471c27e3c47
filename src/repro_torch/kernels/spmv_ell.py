"""Padded-ELL SpMV with the HYB overflow tail fused (``csrc/spmv_ell.cu``).

Counterpart of ``repro.kernels.spmv_ell.ell_spmv``.  One launch covers the
listed shards of the S-stacked slabs:

    y[s, b, r] = sum_w data[s, r, w] * x[s, cols[s, r, w], b]
               + the row's overflow entries, in stored order

``x`` is the batch-minor buffer (S or 1, Lx, B); ``out`` is (S, B, R).
``ovf_ptr`` (S, R+1) holds each row's range of the shard's real overflow
entries (empty for ``ell`` shards).  ``ell_len`` (S, R) holds each row's
count of real slots: the kernel reads slots ``0 .. ell_len[s, r])`` only,
so the slab's slots past it must hold zeros (the executor's do).
``ell_len=None`` means every slot of a row is real.  The plain version
multiplies every slot and ignores ``ell_len``, so the card's check of the
kernel against it also checks that the skipped slots held nothing.
"""
from __future__ import annotations

import torch

from . import _lib

__all__ = ["ell_spmv", "ell_spmv_plain"]


def ell_spmv_plain(data, cols, ovf_rows, ovf_cols, ovf_vals, ovf_ptr, x,
                   sids, out, ell_len=None):
    """The kernel's arithmetic in plain PyTorch over every slot: gather,
    multiply, row sum, then the overflow products added in stored order.
    ``ell_len`` is taken and ignored."""
    R = data.shape[1]
    for sid in sids.tolist():
        xs = x[sid if x.shape[0] > 1 else 0].t().contiguous()   # (B, Lx)
        y = (data[sid] * xs[:, cols[sid].long()]).sum(-1)       # (B, R)
        n = int(ovf_ptr[sid, R])
        if n:
            contrib = ovf_vals[sid, :n] * xs[:, ovf_cols[sid, :n].long()]
            y.index_add_(1, ovf_rows[sid, :n].long(), contrib)
        out[sid] = y
    return out


def ell_spmv(data, cols, ovf_rows, ovf_cols, ovf_vals, ovf_ptr, x, sids, *,
             ell_len=None, out=None):
    """ELL/HYB SpMV over the shards ``sids``; returns ``out`` (S, B, R).

    A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`ell_spmv_plain`.
    """
    S, R, W = data.shape
    B = x.shape[2]
    if out is None:
        out = torch.empty((S, B, R), dtype=torch.float32, device=data.device)
    if data.device.type == "cpu":
        return ell_spmv_plain(data, cols, ovf_rows, ovf_cols, ovf_vals,
                              ovf_ptr, x, sids, out, ell_len)
    f32, i32 = torch.float32, torch.int32
    _lib.check(data.device, data=(data, f32, 3), cols=(cols, i32, 3),
               ovf_cols=(ovf_cols, i32, 2), ovf_vals=(ovf_vals, f32, 2),
               ovf_ptr=(ovf_ptr, i32, 2), x=(x, f32, 3), sids=(sids, i32, 1),
               out=(out, f32, 3))
    if ell_len is not None:
        _lib.check(data.device, ell_len=(ell_len, i32, 2))
    if cols.shape != data.shape or ovf_ptr.shape != (S, R + 1) \
            or (ell_len is not None and ell_len.shape != (S, R)) \
            or out.shape != (S, B, R) or x.shape[0] not in (1, S):
        raise ValueError("ell_spmv: operand shapes disagree")
    if sids.numel() == 0 or B == 0:
        return out
    _lib.call("ell_spmv", "rt_ell_spmv", data.device,
              data.data_ptr(), cols.data_ptr(),
              None if ell_len is None else ell_len.data_ptr(),
              ovf_ptr.data_ptr(), ovf_cols.data_ptr(), ovf_vals.data_ptr(),
              x.data_ptr(), _lib.x_stride(x), sids.data_ptr(), sids.numel(),
              R, W, ovf_vals.shape[1], B, out.data_ptr())
    return out
