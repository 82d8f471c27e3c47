"""The compulsory bound of one SpMV call, and the table of peaks.

What these inputs need, whatever implements them: the matrix read once
as CSR (one float32 value and one int32 column a nonzero, an int32 row
pointer a row, plus one), every x read once and every y written once, in
float32; and 2 FLOP a nonzero and a column.  The time is the larger of
the bytes over the card's HBM bandwidth and the FLOP over its float32
rate.  It does not read the program's own (padded) operands, so a change
of format does not move the yardstick.
"""
from __future__ import annotations

__all__ = ["PEAKS", "compulsory_bytes", "compulsory_flops", "bound_s"]

#: Published peaks (NVIDIA data sheet, H100 SXM5 80 GB, dense, 700 W):
#: HBM3 bytes/s and float32 FLOP/s outside the tensor cores.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def compulsory_bytes(nrows: int, ncols: int, nnz: int, block: int = 1) -> int:
    return (nnz * (4 + 4) + (nrows + 1) * 4
            + ncols * 4 * block + nrows * 4 * block)


def compulsory_flops(nnz: int, block: int = 1) -> int:
    return 2 * nnz * block


def bound_s(nrows: int, ncols: int, nnz: int, block: int = 1) -> dict:
    """``{"s": seconds, "binds": "bytes" | "flops", "bytes", "flops"}``."""
    byts = compulsory_bytes(nrows, ncols, nnz, block)
    flops = compulsory_flops(nnz, block)
    t_bytes = byts / PEAKS["hbm_bytes_per_s"]
    t_flops = flops / PEAKS["fp32_flops_per_s"]
    return {"s": max(t_bytes, t_flops),
            "binds": "bytes" if t_bytes >= t_flops else "flops",
            "bytes": byts, "flops": flops}
