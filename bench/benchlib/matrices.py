"""The benchmark's matrices (host numpy, CSR out): what every frozen
generator shares, and the configuration's matrix made by name.

Each generator is a module of its own, ``bench/generators/<name>.py``,
with one function ``generate(M, nnz, *, seed, sort_device, **params)``
and, where a rehearsal's ``scale`` shrinks more than M and nnz, the
tuple ``SCALED`` of the parameters it shrinks too.  The generators and
``finish`` and ``csr_from_coo`` here are copies of the program's, kept
here so that the yardstick does not move when the program's own copy
does.  The same parameters and seed give the same CSR, bitwise, as the
program's ``data.matrices`` generators (the tests hold them to it).

One step is faster than the original: ``csr_from_coo`` may sort the
(row, col) keys with a stable ``torch.sort`` on a device.  A stable sort
of ``row * M + col`` is the same permutation as ``np.lexsort((cols,
rows))``, and the duplicate sums stay numpy's ``np.add.at`` in that
order, so the result is bitwise the numpy path's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import named

__all__ = ["CSR", "csr_from_coo", "finish", "generator", "make_matrix"]


@dataclasses.dataclass(frozen=True)
class CSR:
    """values (nnz,) float64, col_index (nnz,) int32, row_ptr (M+1,)
    int64: the arrays of the program's ``CSRMatrix``, field for field."""

    shape: tuple
    values: np.ndarray
    col_index: np.ndarray
    row_ptr: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])


def _sorted_order(rows, cols, ncols: int, sort_device):
    if sort_device is None:
        return np.lexsort((cols, rows))
    import torch
    key = torch.from_numpy(rows * ncols + cols).to(sort_device)
    return torch.sort(key, stable=True).indices.cpu().numpy()


def csr_from_coo(rows, cols, vals, shape, sum_duplicates: bool = True,
                 sort_device=None) -> CSR:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = _sorted_order(rows, cols, shape[1], sort_device)
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        key_change = np.empty(rows.size, dtype=bool)
        key_change[0] = True
        key_change[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        group = np.cumsum(key_change) - 1
        uvals = np.zeros(group[-1] + 1, dtype=vals.dtype)
        np.add.at(uvals, group, vals)
        rows, cols, vals = rows[key_change], cols[key_change], uvals
    M = shape[0]
    row_ptr = np.zeros(M + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    np.cumsum(row_ptr, out=row_ptr)
    return CSR(shape=tuple(shape), values=vals.astype(np.float64),
               col_index=cols.astype(np.int32), row_ptr=row_ptr)


def finish(rows, cols, vals, M, symmetric: bool, sort_device) -> CSR:
    keep = (rows >= 0) & (rows < M) & (cols >= 0) & (cols < M)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        vals = np.concatenate([vals, vals])
    return csr_from_coo(rows, cols, vals, (M, M), sort_device=sort_device)


def generator(name: str):
    """The module ``bench/generators/<name>.py``."""
    return named.module("generators", name)


def make_matrix(spec: dict, *, seed: int, scale: float = 1.0,
                sort_device=None) -> CSR:
    """The matrix a configuration's ``matrix`` entry describes.

    ``spec`` holds ``generator`` (a module's name), ``M``, ``nnz`` and
    the generator's own keyword parameters.  ``scale`` < 1 shrinks M, nnz
    and the generator's ``SCALED`` parameters together, as the program's
    ``make_matrix`` does, for rehearsals on the CPU only.  A
    negative seed is taken modulo 2**63."""
    seed %= 1 << 63
    params = dict(spec)
    gen = generator(params.pop("generator"))
    M, nnz = params.pop("M"), params.pop("nnz")
    if scale != 1.0:
        M = max(int(M * scale), 64)
        nnz = max(int(nnz * scale), 4 * M)
        for key in getattr(gen, "SCALED", ()):
            params[key] = max(int(params[key] * scale), 8)
    return gen.generate(M, nnz, seed=seed, sort_device=sort_device,
                        **params)
