"""The split family's own compulsory bound: what its shards' inputs need
a call, and which device operations are the family's.

The bytes are ``bound.compulsory_bytes`` restricted to the shards the
plan runs as ``split``: their nonzeros read once as CSR (a float32 value
and an int32 column each), their rows' pointers (one a row, plus one),
the distinct x elements they read and the y elements they write, in
float32.  The program reports those sizes a call (its counters
``split.nnz``, ``split.rows``, ``split.x_elems``, ``split.y_elems``);
neither the scratch the family allocates nor the exchange's buffer is
counted.  Its bound is these bytes over the card's HBM bandwidth: the
family's 2 FLOP a nonzero stay far under the float32 rate.  Its device
operations are its three kernels, found by name: ``seg_psum_kernel``,
``seg_fixup_kernel<..., false>`` (the seg family's fix-up is ``<...,
true>``) and ``split_combine_kernel``.
"""
from __future__ import annotations

__all__ = ["split_bytes", "is_split_kernel"]


def split_bytes(nnz: float, rows: float, x_elems: float,
                y_elems: float) -> float:
    """Compulsory bytes of the split shards a call."""
    return nnz * (4 + 4) + (rows + 1) * 4 + x_elems * 4 + y_elems * 4


def is_split_kernel(name: str) -> bool:
    """Whether the traced device operation ``name`` (as ``trace.short_name``
    gives it) is one of the split family's kernels."""
    base, _, args = name.partition("<")
    return base in ("seg_psum_kernel", "split_combine_kernel") or \
        (base == "seg_fixup_kernel" and "false" in args)
