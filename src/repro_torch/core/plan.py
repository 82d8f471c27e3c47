"""The split-count policy of the planner (host copy of
``repro.core.plan.split_meta``).  The autotuner itself is a later slice."""
from __future__ import annotations

import functools

from ..kernels.ops import SEG_CHUNK

__all__ = ["SPLIT_CORES", "SPLIT_MIN_SPAN", "split_meta"]

#: Core count the split policy tries to keep busy.  The reference reads
#: it from its machine model's threads per nodelet, which is 64.
SPLIT_CORES = 64
#: Minimum longest-row chunk span before splitting pays.
SPLIT_MIN_SPAN = 4


@functools.lru_cache(maxsize=4096)
def split_meta(nnz: int, max_row_nnz: int, num_cores: int = SPLIT_CORES,
               chunk: int = SEG_CHUNK) -> int:
    """Split count NS for one shard.

    ``span = ceil(max_row_nnz / chunk)`` is the carry chain the seg fix-up
    would serialize.  Shards with ``span < SPLIT_MIN_SPAN`` keep NS=1;
    otherwise NS covers the span and keeps chunks-per-split at or under
    span/2, capped by the chunk count and the core budget, floored to a
    power of two.

    >>> split_meta(100, 10)
    1
    >>> split_meta(8192, 8192)
    16
    """
    chunks = max((nnz + chunk - 1) // chunk, 1)
    span = max((max_row_nnz + chunk - 1) // chunk, 1)
    if span < SPLIT_MIN_SPAN or chunks < 2:
        return 1
    want = max(span, -(-2 * chunks // span))
    ns = max(min(chunks, max(num_cores, 1), want), 1)
    p = 1
    while p * 2 <= ns:
        p *= 2
    return p
