"""The tile and ELL families' own compulsory bounds: what each family's
shards need a call, and which device operations are the family's.

ELL: ``split_bound.split_bytes``'s count over the shards the plan runs
as ``ell``: their nonzeros read once as CSR (a float32 value and an
int32 column each), their rows' pointers (one a row, plus one), the
distinct x elements they read and the y elements they write, in float32.

Tile: a fully dense tile's cells need no column index, so a nonzero of
the shards the plan runs as ``tile`` is its float32 value alone; each
tile adds its block row and block column (two int32), and the distinct
x elements read and the y elements written are float32 as above.  A
kernel that reads every value in float32 cannot read fewer bytes than
either count, so neither share can pass 100%.

The program reports those sizes a call (its counters ``ell.nnz``,
``ell.rows``, ``ell.x_elems``, ``ell.y_elems``; ``tile.nnz``,
``tile.tiles``, ``tile.x_elems``, ``tile.y_elems``); neither the padding
of the family's operands nor the exchange's buffer is counted.  Each
bound is its bytes over the card's HBM bandwidth: 2 FLOP a nonzero stay
far under the float32 rate.  The families' device operations are their
kernels, found by name: ``ell_spmv_kernel`` (the ELL and HYB launch), and
``tile_contrib_kernel`` and, for tiles of other shapes,
``tile_contrib_general_kernel``.
"""
from __future__ import annotations

from . import split_bound

__all__ = ["ell_bytes", "tile_bytes", "is_ell_kernel", "is_tile_kernel"]


#: Compulsory bytes of the ELL shards a call: ``ell_bytes(nnz, rows,
#: x_elems, y_elems)``, the split family's count.
ell_bytes = split_bound.split_bytes


def tile_bytes(nnz: float, tiles: float, x_elems: float,
               y_elems: float) -> float:
    """Compulsory bytes of the tile shards a call."""
    return nnz * 4 + tiles * (4 + 4) + x_elems * 4 + y_elems * 4


def _base(name: str) -> str:
    return name.partition("<")[0]


def is_ell_kernel(name: str) -> bool:
    """Whether the traced device operation ``name`` (as ``trace.short_name``
    gives it) is the ELL family's kernel."""
    return _base(name) == "ell_spmv_kernel"


def is_tile_kernel(name: str) -> bool:
    """Whether the traced device operation ``name`` is one of the tile
    family's kernels."""
    return _base(name) in ("tile_contrib_kernel",
                           "tile_contrib_general_kernel")
