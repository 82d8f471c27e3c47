"""Matrix reordering techniques (paper §IV-E).

* ``none``   — identity.
* ``random`` — Fisher-Yates permutation of rows and columns (the paper's
               Valiant-style hot-spot spreader).
* ``bfs``    — breadth-first traversal order of the symmetrized adjacency
               graph (Al-Furaih & Ranka style); pulls non-zeros toward the
               diagonal.
* ``metis``  — METIS-like multilevel behaviour approximated with recursive
               greedy graph growing (GGGP): BFS-grow one half, recurse, then
               concatenate parts.  Produces balanced, diagonal-clustered
               partitions like METIS does in the paper's Fig. 9 without the
               external library.
* ``degree`` — descending-degree order (extra, beyond paper, useful for the
               power-law suite).

Symmetric permutations P A P^T are used throughout (the paper permutes rows
and columns together).
"""
from __future__ import annotations

import numpy as np

from .sparse_matrix import CSRMatrix, csr_from_coo, csr_row_nnz

__all__ = ["reorder", "reordering_permutation", "REORDERINGS"]

REORDERINGS = ("none", "random", "bfs", "metis", "degree")


def _symmetrized_adjacency(csr: CSRMatrix) -> CSRMatrix:
    """Pattern of A + A^T (no self loops) as CSR with unit values."""
    M = csr.nrows
    rows = np.repeat(np.arange(M), csr_row_nnz(csr))
    cols = csr.col_index.astype(np.int64)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    r, c = r[keep], c[keep]
    return csr_from_coo(r, c, np.ones(r.shape[0]), (M, M), sum_duplicates=True)


def _bfs_order(adj: CSRMatrix, seeds: np.ndarray | None = None) -> np.ndarray:
    """Vectorized frontier BFS; returns vertices in discovery order."""
    M = adj.nrows
    visited = np.zeros(M, dtype=bool)
    order = np.empty(M, dtype=np.int64)
    filled = 0
    rp, ci = adj.row_ptr, adj.col_index.astype(np.int64)
    seed_iter = iter(seeds if seeds is not None else np.arange(M))
    while filled < M:
        seed = -1
        for s in seed_iter:
            if not visited[s]:
                seed = int(s)
                break
        if seed < 0:  # seeds exhausted; fall back to first unvisited
            seed = int(np.flatnonzero(~visited)[0])
        frontier = np.array([seed], dtype=np.int64)
        visited[seed] = True
        while frontier.size:
            order[filled : filled + frontier.size] = frontier
            filled += frontier.size
            counts = rp[frontier + 1] - rp[frontier]
            total = int(counts.sum())
            if total == 0:
                break
            # Gather all neighbours of the frontier in one shot.
            offsets = np.repeat(rp[frontier], counts) + (
                np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
            )
            nbrs = ci[offsets]
            nbrs = np.unique(nbrs[~visited[nbrs]])
            visited[nbrs] = True
            frontier = nbrs
    return order


def _gggp_bisect(adj: CSRMatrix, verts: np.ndarray, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Greedy graph growing: BFS-grow half of ``verts`` from a seed."""
    inset = np.zeros(adj.nrows, dtype=bool)
    inset[verts] = True
    target = verts.size // 2
    grown = np.zeros(adj.nrows, dtype=bool)
    seed = int(verts[rng.integers(verts.size)])
    frontier = np.array([seed], dtype=np.int64)
    grown[seed] = True
    count = 1
    rp, ci = adj.row_ptr, adj.col_index.astype(np.int64)
    while count < target and frontier.size:
        counts = rp[frontier + 1] - rp[frontier]
        total = int(counts.sum())
        if total == 0:
            break
        offsets = np.repeat(rp[frontier], counts) + (
            np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        nbrs = ci[offsets]
        nbrs = np.unique(nbrs[inset[nbrs] & ~grown[nbrs]])
        if nbrs.size == 0:
            break
        take = nbrs[: max(target - count, 0)]
        grown[take] = True
        count += take.size
        frontier = take
    if count < target:  # disconnected: top up with arbitrary in-set vertices
        rest = verts[~grown[verts]]
        extra = rest[: target - count]
        grown[extra] = True
    left = verts[grown[verts]]
    right = verts[~grown[verts]]
    return left, right


def _metis_like_order(adj: CSRMatrix, parts: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pieces = [np.arange(adj.nrows, dtype=np.int64)]
    while len(pieces) < parts:
        nxt = []
        for piece in pieces:
            if piece.size <= 1:
                nxt.append(piece)
                continue
            l, r = _gggp_bisect(adj, piece, rng)
            nxt.extend([l, r])
        pieces = nxt
    # BFS-order within each part for intra-part locality, then concatenate.
    out = []
    for piece in pieces:
        mask = np.zeros(adj.nrows, dtype=bool)
        mask[piece] = True
        sub_order = [v for v in _bfs_order(adj, seeds=piece) if mask[v]]
        out.append(np.asarray(sub_order, dtype=np.int64)[: piece.size])
    return np.concatenate(out) if out else np.arange(adj.nrows)


def reordering_permutation(csr: CSRMatrix, method: str, *, seed: int = 0,
                           parts: int = 8) -> np.ndarray:
    """Compute the symmetric row+column permutation for one reordering.

    Parameters
    ----------
    csr : CSRMatrix
        Matrix whose (symmetrized) adjacency drives the graph orderings.
    method : {'none', 'random', 'bfs', 'metis', 'degree'}
        Reordering technique (see the module docstring; the accepted
        spellings are :data:`REORDERINGS`).
    seed : int, optional
        RNG seed for the stochastic methods (``random``, ``metis``).
    parts : int, optional
        Target part count for the METIS-like recursive bisection.

    Returns
    -------
    numpy.ndarray
        ``perm`` of shape ``(nrows,)`` with ``perm[old] = new`` — apply as
        ``csr.permuted(perm, perm)`` for the paper's P A P^T.

    Raises
    ------
    ValueError
        If ``method`` is not one of :data:`REORDERINGS`.

    Examples
    --------
    ``none`` is the identity, and every method returns a bijection:

    >>> import numpy as np
    >>> from repro_torch.core.sparse_matrix import csr_from_coo
    >>> from repro_torch.core.reorder import reordering_permutation
    >>> A = csr_from_coo(np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0]),
    ...                  np.ones(4), (4, 4))
    >>> reordering_permutation(A, "none").tolist()
    [0, 1, 2, 3]
    >>> sorted(reordering_permutation(A, "random", seed=7).tolist())
    [0, 1, 2, 3]

    ``degree`` puts the heaviest row first:

    >>> B = csr_from_coo(np.array([2, 2, 2, 0]), np.array([0, 1, 3, 2]),
    ...                  np.ones(4), (4, 4))
    >>> int(reordering_permutation(B, "degree")[2])   # row 2 has 3 nnz
    0
    """
    M = csr.nrows
    if method == "none":
        return np.arange(M, dtype=np.int64)
    if method == "random":
        rng = np.random.default_rng(seed)
        new_of_old = np.empty(M, dtype=np.int64)
        new_of_old[rng.permutation(M)] = np.arange(M)  # Fisher-Yates via rng
        return new_of_old
    adj = _symmetrized_adjacency(csr)
    if method == "bfs":
        order = _bfs_order(adj)  # order[k] = old vertex at new position k
    elif method == "metis":
        order = _metis_like_order(adj, parts, seed)
    elif method == "degree":
        order = np.argsort(-csr_row_nnz(csr), kind="stable")
    else:
        raise ValueError(f"unknown reordering: {method!r}")
    new_of_old = np.empty(M, dtype=np.int64)
    new_of_old[order] = np.arange(M)
    return new_of_old


def reorder(csr: CSRMatrix, method: str, *, seed: int = 0, parts: int = 8) -> CSRMatrix:
    """Apply a symmetric reordering: return P A P^T.

    Parameters
    ----------
    csr : CSRMatrix
        Square matrix (the paper permutes rows and columns together).
    method : {'none', 'random', 'bfs', 'metis', 'degree'}
        Reordering technique; ``none`` returns ``csr`` unchanged.
    seed, parts : int, optional
        Passed through to :func:`reordering_permutation`.

    Returns
    -------
    CSRMatrix
        The permuted matrix (same shape, same nnz multiset).

    Raises
    ------
    ValueError
        If the matrix is not square.

    Examples
    --------
    Reordering preserves the spectrum of products: ``A @ x`` commutes with
    the permutation (this is the invariant
    ``tests/test_partition_invariants.py`` sweeps):

    >>> import numpy as np
    >>> from repro_torch.core.sparse_matrix import csr_from_coo, csr_to_dense
    >>> from repro_torch.core.reorder import reorder, reordering_permutation
    >>> A = csr_from_coo(np.array([0, 1, 2, 0]), np.array([1, 2, 0, 2]),
    ...                  np.array([1.0, 2.0, 3.0, 4.0]), (3, 3))
    >>> perm = reordering_permutation(A, "random", seed=3)
    >>> B = reorder(A, "random", seed=3)
    >>> x = np.array([1.0, 2.0, 3.0])
    >>> xp = np.empty(3); xp[perm] = x          # x in the new order
    >>> yp = csr_to_dense(B) @ xp
    >>> np.allclose(yp[perm], csr_to_dense(A) @ x)
    True
    """
    if csr.nrows != csr.ncols:
        raise ValueError("paper applies symmetric reorderings to square matrices")
    perm = reordering_permutation(csr, method, seed=seed, parts=parts)
    if method == "none":
        return csr
    return csr.permuted(perm, perm)
