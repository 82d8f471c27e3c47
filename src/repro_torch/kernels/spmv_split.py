"""Split-nnz SpMV stage 2: the split-axis combine (``csrc/spmv_split.cu``).

Counterpart of ``repro.kernels.spmv_split.split_combine``.  Stage 1 is
:func:`~repro_torch.kernels.spmv_seg.seg_psum` followed by
:func:`~repro_torch.kernels.spmv_seg.seg_fixup` with ``num_splits=NS``.

    y[sids[k], b, r] = sum_t part[k, b, t, r]     (t = 0 .. NS-1, in order)
"""
from __future__ import annotations

import torch

from . import _lib

__all__ = ["split_combine", "split_combine_plain"]


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
    _lib.call("split_combine", "rt_split_combine", part.data_ptr(),
              sids.data_ptr(), n, NS, R, B, out.data_ptr())
    return out
