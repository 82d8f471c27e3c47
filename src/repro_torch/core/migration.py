"""Exact migration / remote-traffic accounting (host copy of the part of
``repro.core.migration`` that :class:`~repro_torch.core.program.SpmvProgram`
carries).

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

__all__ = ["TrafficReport", "count_migrations", "remote_access_matrix"]


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
