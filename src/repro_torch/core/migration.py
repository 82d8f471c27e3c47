"""Exact migration / remote-traffic accounting (host copy of the part of
``repro.core.migration`` that :class:`~repro_torch.core.program.SpmvProgram`
and the planner's cost model use).

A migration is counted every time the thread walk's current nodelet
changes (home, x owners of row r's entries, home, ...); remote x loads
and remote b updates are counted per access.  Same arithmetic as the
reference, so the reports compare equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .layout import VectorLayout
from .partition import Partition
from .sparse_matrix import CSRMatrix, csr_row_nnz

__all__ = ["TrafficReport", "count_migrations", "remote_access_matrix",
           "migration_arrivals", "shard_load_map"]


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    migrations: int                 # owner changes in the thread walk
    remote_x_loads: int             # x loads not on the home nodelet
    remote_b_updates: int           # b stores issued to a remote nodelet
    mem_instr_per_nodelet: np.ndarray   # (P,) memory instructions executed
    inbound_x_loads: np.ndarray     # (P,) x loads *served by* each nodelet
    nnz_per_nodelet: np.ndarray     # (P,) work assigned to each nodelet

    @property
    def hotspot_share(self) -> float:
        """Fraction of all x loads served by the single hottest nodelet."""
        tot = self.inbound_x_loads.sum()
        return float(self.inbound_x_loads.max() / tot) if tot else 0.0


def count_migrations(csr: CSRMatrix, part: Partition, x_layout: VectorLayout,
                     b_layout: VectorLayout) -> TrafficReport:
    """Count migrations for SpMV under a partition + vector layouts."""
    P = part.num_shards
    M = csr.nrows
    nnz_per_row = csr_row_nnz(csr)
    rows = np.repeat(np.arange(M), nnz_per_row)           # (nnz,)
    home = part.owner_of_rows(M)                          # (M,) row -> nodelet
    home_of_nnz = home[rows]                              # (nnz,)
    owners = x_layout.owner_of(csr.col_index)             # (nnz,)

    same_row = np.empty(csr.nnz, dtype=bool)
    if csr.nnz:
        same_row[0] = False
        same_row[1:] = rows[1:] == rows[:-1]
    inner = int(np.count_nonzero(same_row[1:] & (owners[1:] != owners[:-1]))) if csr.nnz > 1 else 0
    starts = csr.row_ptr[:-1][nnz_per_row > 0]
    enter = int(np.count_nonzero(owners[starts] != home_of_nnz[starts]))
    ends = (csr.row_ptr[1:] - 1)[nnz_per_row > 0]
    leave = int(np.count_nonzero(owners[ends] != home_of_nnz[ends]))
    migrations = inner + enter + leave

    remote_x = int(np.count_nonzero(owners != home_of_nnz))
    b_owner = b_layout.owner_of(np.arange(M))
    remote_b = int(np.count_nonzero(b_owner != home))

    mem = np.zeros(P, dtype=np.int64)
    np.add.at(mem, home_of_nnz, 2)
    np.add.at(mem, home, 2)
    np.add.at(mem, owners, 1)
    np.add.at(mem, b_owner, 1)

    inbound = np.zeros(P, dtype=np.int64)
    np.add.at(inbound, owners, 1)

    nnz_per_nodelet = np.zeros(P, dtype=np.int64)
    np.add.at(nnz_per_nodelet, home_of_nnz, 1)

    return TrafficReport(
        migrations=migrations,
        remote_x_loads=remote_x,
        remote_b_updates=remote_b,
        mem_instr_per_nodelet=mem,
        inbound_x_loads=inbound,
        nnz_per_nodelet=nnz_per_nodelet,
    )


def remote_access_matrix(csr: CSRMatrix, part: Partition,
                         x_layout: VectorLayout) -> np.ndarray:
    """(P, P) int64 matrix T where T[p, q] = x loads shard p issues into
    shard q (off-diagonal mass is exchange traffic)."""
    P = part.num_shards
    M = csr.nrows
    rows = np.repeat(np.arange(M), csr_row_nnz(csr))
    home_of_nnz = part.owner_of_rows(M)[rows]
    owners = x_layout.owner_of(csr.col_index)
    T = np.zeros((P, P), dtype=np.int64)
    np.add.at(T, (home_of_nnz, owners), 1)
    return T


def migration_arrivals(csr: CSRMatrix, part: Partition,
                       x_layout: VectorLayout,
                       col_weight: np.ndarray | None = None) -> np.ndarray:
    """(P,) migrations *arriving at* each nodelet under the thread walk.

    Same walk as :func:`count_migrations` (home, x owners..., home per row),
    but attributed to the *destination* nodelet of each owner change.  This
    is the ingress pressure the Nodelet Queue Manager must absorb — the
    quantity that saturates on cop20k_A's nodelet 0 (§IV-D) and that the
    plan cost model (``core/plan.py``) uses as its hot-spot term.

    ``col_weight`` (optional, (ncols,) float, in *this matrix's* index
    order) weights each arrival event by the activity of the x column that
    triggered it — the first-order model of a serving workload where only
    some columns of x are hot (a load at an inactive column never happens,
    so neither does the migration it would have caused).  The return event
    back to the home nodelet is weighted by the row's last column, the
    access that stranded the thread remotely.  Weighted results are float64
    expected counts; ``col_weight=None`` keeps the exact integer counts.
    """
    P = part.num_shards
    M = csr.nrows
    nnz_per_row = csr_row_nnz(csr)
    rows = np.repeat(np.arange(M), nnz_per_row)
    home = part.owner_of_rows(M)
    home_of_nnz = home[rows]
    owners = x_layout.owner_of(csr.col_index)
    if col_weight is None:
        w = None
        arrivals = np.zeros(P, dtype=np.int64)
    else:
        w = np.asarray(col_weight, dtype=np.float64)[csr.col_index]
        arrivals = np.zeros(P, dtype=np.float64)

    if csr.nnz > 1:
        same_row = rows[1:] == rows[:-1]
        moved = same_row & (owners[1:] != owners[:-1])
        np.add.at(arrivals, owners[1:][moved],
                  1 if w is None else w[1:][moved])
    starts = csr.row_ptr[:-1][nnz_per_row > 0]
    enter = owners[starts] != home_of_nnz[starts]
    np.add.at(arrivals, owners[starts][enter],
              1 if w is None else w[starts][enter])
    ends = (csr.row_ptr[1:] - 1)[nnz_per_row > 0]
    leave = owners[ends] != home_of_nnz[ends]
    np.add.at(arrivals, home_of_nnz[ends][leave],
              1 if w is None else w[ends][leave])
    return arrivals


def shard_load_map(csr: CSRMatrix, part: Partition,
                   x_layout: VectorLayout,
                   b_layout: VectorLayout | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Precomputed column→shard load attribution for cheap online monitoring.

    Returns ``(load_map, base)`` where ``load_map`` is (P, ncols) float64
    and ``base`` is (P,) float64, such that for any per-column activity
    vector ``w`` (this matrix's index order) the expected per-nodelet
    memory-instruction load of one served SpMV is::

        load = load_map @ w + base

    Attribution matches :func:`count_migrations`'s per-nodelet accounting:
    each stored (i, j) costs 2 instructions at row i's home (value +
    colIndex load) and 1 at x[j]'s owner, both gated by column j's
    activity; the per-row overhead (rowPtr read + b accumulate at home,
    plus the b-owner update) is activity-independent and lands in
    ``base``.  With ``w = 1`` the sum reproduces
    ``count_migrations(...).mem_instr_per_nodelet`` exactly — the serving
    monitor's load metric degrades gracefully to the static one under
    uniform traffic.

    The map costs O(P * ncols) memory once per built plan; after that a
    monitoring window is a single matvec, which is what lets the
    rebalancer watch every request without re-walking the matrix.
    """
    P = part.num_shards
    M = csr.nrows
    rows = np.repeat(np.arange(M), csr_row_nnz(csr))
    home = part.owner_of_rows(M)
    home_of_nnz = home[rows]
    owners = x_layout.owner_of(csr.col_index)
    cols = csr.col_index

    load_map = np.zeros((P, csr.ncols), dtype=np.float64)
    np.add.at(load_map, (home_of_nnz, cols), 2.0)
    np.add.at(load_map, (owners, cols), 1.0)

    base = np.zeros(P, dtype=np.float64)
    np.add.at(base, home, 2.0)
    b_owner = (b_layout or x_layout).owner_of(np.arange(M))
    np.add.at(base, b_owner, 1.0)
    return load_map, base
