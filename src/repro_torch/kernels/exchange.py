"""The exchange's row gather (``csrc/exchange.cu``).

:func:`gather_rows` builds the remote pass's batch-minor x buffers: row i
of the result is row ``index[i]`` of the flat (N, B) x, one element's B
columns.  The reference takes the same rows with ``jnp.take`` (an XLA
gather, not a Pallas kernel).
"""
from __future__ import annotations

import torch

from . import _lib

__all__ = ["gather_rows", "gather_rows_plain"]


def gather_rows_plain(x, index, out):
    """``x[index]`` by advanced indexing."""
    out[:] = x[index]
    return out


def gather_rows(x, index, *, out=None):
    """Rows ``x[index]`` of the (N, B) float32 ``x`` for an int64 index of
    any shape; returns ``index.shape + (B,)``.  A CUDA tensor launches the
    kernel; a CPU tensor runs :func:`gather_rows_plain`."""
    B = x.shape[1]
    if out is None:
        out = torch.empty(tuple(index.shape) + (B,), dtype=torch.float32,
                          device=x.device)
    if x.device.type == "cpu":
        return gather_rows_plain(x, index, out)
    _lib.check(x.device, x=(x, torch.float32, 2),
               index=(index, torch.int64, index.dim()),
               out=(out, torch.float32, index.dim() + 1))
    if out.shape != tuple(index.shape) + (B,):
        raise ValueError("gather_rows: operand shapes disagree")
    if index.numel() == 0 or B == 0:
        return out
    _lib.call("gather_rows", "rt_gather_rows", x.device, x.data_ptr(),
              index.data_ptr(), index.numel(), B, out.data_ptr())
    return out
