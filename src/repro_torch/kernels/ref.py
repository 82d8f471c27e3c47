"""The plain PyTorch versions of the port's kernels, in one place.

Each follows its kernel's own arithmetic (gather, multiply, ``cumsum``,
piece differences, in-order sums) and lives beside its kernel; a wrapper
runs it for a CPU tensor, and ``chip_smoke.py`` holds each kernel to it on
the card.
"""
from .spmv_ell import ell_spmv_plain
from .spmv_seg import seg_fixup_plain, seg_psum_plain
from .spmv_split import split_combine_plain
from .spmv_tile import tile_contrib_plain

__all__ = ["ell_spmv_plain", "seg_psum_plain", "seg_fixup_plain",
           "split_combine_plain", "tile_contrib_plain"]
