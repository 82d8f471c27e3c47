"""Work-distribution strategies (host copy of ``repro.core.partition``).

* ``row``     — each shard gets an equal count of contiguous rows.
* ``nonzero`` — contiguous rows packed until ~NNZ/shards non-zeros per
                shard (``nnz`` is an accepted alias).

:func:`nnz_chunk_starts` is the element-level analogue the segmented
formats cut their chunks with.  The arithmetic is the reference's, so the
row ranges are bitwise-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .sparse_matrix import CSRMatrix, csr_row_nnz

__all__ = ["Partition", "partition_rows", "partition_nonzeros",
           "make_partition", "nnz_chunk_starts", "DISTRIBUTIONS"]

#: Accepted ``make_partition`` / ``SpmvPlan.distribution`` spellings.
DISTRIBUTIONS = ("row", "nonzero", "nnz")


@dataclasses.dataclass(frozen=True)
class Partition:
    """Row ranges per shard: shard p owns rows [starts[p], starts[p+1])."""

    strategy: str
    num_shards: int
    starts: np.ndarray  # (P+1,) int64, starts[0] == 0, starts[-1] == M

    def rows_of(self, p: int) -> range:
        return range(int(self.starts[p]), int(self.starts[p + 1]))

    def shard_csr(self, csr: CSRMatrix, p: int) -> CSRMatrix:
        """Shard p's mini-CSR (relative row offsets)."""
        return csr.row_slice(int(self.starts[p]), int(self.starts[p + 1]))

    def rows_per_shard(self) -> np.ndarray:
        return np.diff(self.starts)

    def nnz_per_shard(self, csr: CSRMatrix) -> np.ndarray:
        return self.starts_nnz(csr)

    def starts_nnz(self, csr: CSRMatrix) -> np.ndarray:
        """(P,) non-zeros of each shard's row range."""
        return np.diff(csr.row_ptr[self.starts])

    def owner_of_rows(self, M: int) -> np.ndarray:
        """(M,) shard id owning each row."""
        return np.searchsorted(self.starts, np.arange(M), side="right") - 1

    def thread_splits(self, csr: CSRMatrix,
                      threads_per_shard: int) -> list[np.ndarray]:
        """Sub-split each shard's rows among the Emu model's worker threads:
        equal rows per thread under the row strategy, ~equal non-zeros per
        thread under the non-zero one."""
        out = []
        for p in range(self.num_shards):
            r0, r1 = int(self.starts[p]), int(self.starts[p + 1])
            sub = csr.row_slice(r0, r1)
            if self.strategy == "row":
                t_starts = _even_row_starts(r1 - r0, threads_per_shard) + r0
            else:
                t = partition_nonzeros(sub, threads_per_shard)
                t_starts = t.starts + r0
            out.append(t_starts.astype(np.int64))
        return out


def _even_row_starts(M: int, P: int) -> np.ndarray:
    base, rem = divmod(M, P)
    sizes = np.full(P, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def partition_rows(csr: CSRMatrix, num_shards: int) -> Partition:
    """Equal-row contiguous blocks (the paper's *row* distribution)."""
    return Partition("row", num_shards, _even_row_starts(csr.nrows, num_shards))


def partition_nonzeros(csr: CSRMatrix, num_shards: int,
                       nnz_weight: np.ndarray | None = None) -> Partition:
    """Contiguous row blocks with ~equal non-zeros: a searchsorted over
    the cumulative nnz curve.  ``nnz_weight`` ((nnz,) float, in
    stored-entry order) splits by equal *expected work* instead: the
    curve is the weighted one (a primitive for callers that manage their
    own partitions; plans stay weight-free)."""
    M = csr.nrows
    if nnz_weight is None:
        curve = csr.row_ptr[1:].astype(np.float64)
        total = float(csr.nnz)
    else:
        w = np.asarray(nnz_weight, dtype=np.float64)
        if w.shape[0] != csr.nnz:
            raise ValueError(f"nnz_weight has {w.shape[0]} entries, "
                             f"matrix stores {csr.nnz}")
        per_row = np.zeros(M, dtype=np.float64)
        np.add.at(per_row, np.repeat(np.arange(M), csr_row_nnz(csr)), w)
        curve = np.cumsum(per_row)
        total = float(curve[-1]) if M else 0.0
    targets = (np.arange(1, num_shards, dtype=np.float64) * total / num_shards)
    cut = np.searchsorted(curve, targets, side="left") + 1
    starts = np.concatenate([[0], cut, [M]]).astype(np.int64)
    # Monotonicity guard for degenerate matrices (empty rows at the ends).
    np.maximum.accumulate(starts, out=starts)
    starts = np.minimum(starts, M)
    return Partition("nonzero", num_shards, starts)


def nnz_chunk_starts(nnz: int, chunk: int) -> np.ndarray:
    """Element-space chunk boundaries: ceil(nnz/chunk) chunks of exactly
    ``chunk`` elements (the last one short)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n_chunks = max((nnz + chunk - 1) // chunk, 1)
    starts = np.minimum(np.arange(n_chunks + 1, dtype=np.int64) * chunk, nnz)
    return starts


def make_partition(csr: CSRMatrix, num_shards: int, strategy: str,
                   nnz_weight: np.ndarray | None = None) -> Partition:
    """The partition of ``strategy``; ``nnz_weight`` reaches
    :func:`partition_nonzeros` and is ignored under ``"row"``."""
    if strategy == "row":
        return partition_rows(csr, num_shards)
    if strategy in ("nonzero", "nnz"):
        return partition_nonzeros(csr, num_shards, nnz_weight=nnz_weight)
    raise ValueError(f"unknown work-distribution strategy: {strategy!r}; "
                     f"expected one of {DISTRIBUTIONS}")
