"""Synthetic generators matched to the paper's Table I matrix suite.

The UF Sparse Matrix Collection is not available offline, so each matrix is
re-synthesized to match the *structural properties the paper's analysis
depends on*: dimensions, nnz, density, symmetry, and — critically — the spy
pattern (Fig. 4) that drives layout/migration behaviour:

* ford1        18k^2,   100k  — narrow banded FEM mesh
* cop20k_A     120k^2,  2.6M  — banded + a dense column arrowhead: ~25% of
                                all nnz hit columns owned by shard 0, the
                                exact hot-spot condition of §IV-D
* webbase-1M   1M^2,    3.1M  — power-law rows/cols, scattered
* rmat         445k^2,  7.4M  — RMAT(a,b,c) = (0.45, 0.22, 0.22) per paper
* nd24k        72k^2,   28.7M — dense diagonal blocks (3D ND mesh)
* audikw_1     943k^2,  77.6M — wide-band FEM

``scale`` shrinks dims and nnz together (pattern-preserving).  This is
the port's copy of ``repro.data.matrices``: the same seed gives the same
matrix, bitwise.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ..core.sparse_matrix import CSRMatrix, csr_from_coo

__all__ = ["PAPER_SUITE", "make_matrix", "banded", "arrow_fem", "powerlaw",
           "rmat", "dense_blocks", "mixed_structure", "powerlaw_tail",
           "halo_spikes", "blocked_band"]


def _finish(rows, cols, vals, M, symmetric: bool) -> CSRMatrix:
    keep = (rows >= 0) & (rows < M) & (cols >= 0) & (cols < M)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        vals = np.concatenate([vals, vals])
    return csr_from_coo(rows, cols, vals, (M, M))


def banded(M: int, nnz: int, bandwidth: int, *, seed: int = 0,
           symmetric: bool = True, scatter_frac: float = 0.12) -> CSRMatrix:
    """Banded FEM-like pattern.  ``scatter_frac`` of entries land off-band
    (real FEM matrices are never perfectly banded — this keeps the
    block-layout migration ratio in the paper's 1.42-6.3x range)."""
    rng = np.random.default_rng(seed)
    n = nnz if not symmetric else nnz // 2 + M
    rows = rng.integers(0, M, n)
    off = rng.integers(-bandwidth, bandwidth + 1, n)
    cols = rows + off
    n_sc = int(n * scatter_frac)
    if n_sc:
        cols[:n_sc] = rng.integers(0, M, n_sc)
    vals = rng.standard_normal(n)
    # Always include the diagonal (FEM matrices have one).
    rows = np.concatenate([rows, np.arange(M)])
    cols = np.concatenate([cols, np.arange(M)])
    vals = np.concatenate([vals, np.ones(M)])
    return _finish(rows, cols, vals, M, symmetric)


def arrow_fem(M: int, nnz: int, *, hot_frac: float = 0.125,
              dense_boost: float = 3.7, seed: int = 0) -> CSRMatrix:
    """cop20k_A-like: FEM mesh whose *original ordering* concentrates ~25%
    of all x-accesses on the first ``hot_frac`` of columns (§IV-D), while the
    underlying graph stays mesh-local so BFS/METIS can re-band it.

    Construction: a 1-D band mesh where vertices in a refined region (the
    first ``hot_frac`` of mesh space) carry ``dense_boost``x edges; the
    refined vertices keep indices [0, hot_frac*M) but *all other vertices are
    scattered randomly* — so in matrix order the refined columns are
    referenced from rows everywhere (hot-spot), yet a BFS recovers the mesh
    band.  This matches the paper's observation that reordering fixes
    cop20k_A: its hot-spot is an ordering artifact, not intrinsic hubness.
    """
    rng = np.random.default_rng(seed)
    stride = max(int(round(1.0 / hot_frac)), 2)          # refined = every 8th
    refined = (np.arange(M) % stride) == 0               # in mesh space
    n_edges = nnz // 2
    boost = dense_boost
    k = max(int(n_edges / (M * (1.0 + (boost - 1.0) / stride))), 1)
    counts = np.where(refined, int(k * boost), k).astype(np.int64)
    window = max(M // 64, 8)
    src = np.repeat(np.arange(M), counts)
    dst = src + rng.integers(1, window + 1, src.shape[0])
    ok = dst < M
    src, dst = src[ok], dst[ok]
    # Renumber: refined vertices take the leading index block (the hot
    # columns), everyone else follows in mesh order.
    perm = np.empty(M, dtype=np.int64)
    perm[refined] = np.arange(int(refined.sum()))
    perm[~refined] = int(refined.sum()) + np.arange(int((~refined).sum()))
    src, dst = perm[src], perm[dst]
    rows = np.concatenate([src, np.arange(M)])
    cols = np.concatenate([dst, np.arange(M)])
    vals = rng.standard_normal(rows.shape[0])
    return _finish(rows, cols, vals, M, symmetric=True)


def halo_spikes(M: int, nnz: int, *, n_broad: int | None = None,
                bandwidth: int = 8, broad_frac: float = 0.55,
                seed: int = 0) -> CSRMatrix:
    """Exchange-bound workload: a tight local band plus *broad-reader* rows.

    The background is a narrow band (offsets within ``bandwidth``), so
    under a contiguous row partition almost every background row reads
    only columns its own shard owns — local-slice work the pipelined
    executor can run while the exchange is in flight.  On top of it,
    ``n_broad`` rows (spread evenly over the row range, so every shard
    owns a few) each gather ``broad_frac`` of the nnz budget from
    uniform-random columns across the whole index range.  Each shard's
    unique remote-column set is then large (the broad rows' gathers)
    while its remote *rows* are few — the regime where the exchange term
    rivals the kernel term and overlap pays, unlike ``mixed_structure``
    (short scattered rows: every row slightly remote, nothing to hide
    the exchange behind) or ``powerlaw_tail`` (uniform scattered
    background, no local slice at all).
    """
    rng = np.random.default_rng(seed)
    if n_broad is None:
        n_broad = max(M // 128, 8)
    n_brd = int(nnz * broad_frac)
    n_bg = max(nnz - n_brd - M, 0)
    bg_rows = rng.integers(0, M, n_bg)
    bg_cols = np.clip(bg_rows + rng.integers(-bandwidth, bandwidth + 1,
                                             n_bg), 0, M - 1)
    broad_ids = (np.arange(n_broad) * M) // n_broad + M // (2 * n_broad)
    brd_rows = np.repeat(broad_ids, n_brd // n_broad)
    brd_cols = rng.integers(0, M, brd_rows.shape[0])
    rows = np.concatenate([bg_rows, brd_rows, np.arange(M)])
    cols = np.concatenate([bg_cols, brd_cols, np.arange(M)])
    vals = np.concatenate([rng.standard_normal(n_bg + brd_rows.shape[0]),
                           np.ones(M)])
    return _finish(rows, cols, vals, M, symmetric=False)


def powerlaw(M: int, nnz: int, *, alpha: float = 1.8, hub_frac: float = 0.4,
             seed: int = 0) -> CSRMatrix:
    """webbase-like scattered power-law: a uniform background plus a
    zipf-weighted hub component on scattered row/col ids (non-symmetric)."""
    rng = np.random.default_rng(seed)
    n_hub = int(nnz * hub_frac)
    n_uni = nnz - n_hub
    perm_r, perm_c = rng.permutation(M), rng.permutation(M)
    rows = np.concatenate([rng.integers(0, M, n_uni),
                           perm_r[rng.zipf(alpha, n_hub) % M]])
    cols = np.concatenate([rng.integers(0, M, n_uni),
                           perm_c[rng.zipf(alpha, n_hub) % M]])
    vals = rng.standard_normal(nnz)
    rows = np.concatenate([rows, np.arange(M)])
    cols = np.concatenate([cols, np.arange(M)])
    vals = np.concatenate([vals, np.ones(M)])
    return _finish(rows, cols, vals, M, symmetric=False)


def rmat(M: int, nnz: int, *, a: float = 0.45, b: float = 0.22, c: float = 0.22,
         seed: int = 0) -> CSRMatrix:
    """RMAT with the paper's (a, b, c) = (0.45, 0.22, 0.22)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(M, 2))))
    size = 1 << scale
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    p = np.array([a, b, c, 1.0 - a - b - c])
    for level in range(scale):
        quad = rng.choice(4, size=nnz, p=p)
        half = size >> (level + 1)
        rows += np.where((quad == 2) | (quad == 3), half, 0)
        cols += np.where((quad == 1) | (quad == 3), half, 0)
    keep = (rows < M) & (cols < M)
    vals = rng.standard_normal(nnz)
    return _finish(rows[keep], cols[keep], vals[keep], M, symmetric=False)


def dense_blocks(M: int, nnz: int, *, nblocks: int = 24, seed: int = 0) -> CSRMatrix:
    """nd24k-like: dense clusters on the diagonal (high density FEM)."""
    rng = np.random.default_rng(seed)
    n = nnz // 2
    starts = np.sort(rng.integers(0, M, nblocks))
    bsize = max(M // nblocks, 8)
    blk = rng.integers(0, nblocks, n)
    r = starts[blk] + rng.integers(0, bsize, n)
    c = starts[blk] + rng.integers(0, bsize, n)
    n_sc = int(n * 0.08)                     # off-block scatter (see banded)
    if n_sc:
        c[:n_sc] = rng.integers(0, M, n_sc)
    vals = rng.standard_normal(n)
    rows = np.concatenate([r, np.arange(M)])
    cols = np.concatenate([c, np.arange(M)])
    vals = np.concatenate([vals, np.ones(M)])
    return _finish(rows, cols, vals, M, symmetric=True)


def _to_coo(csr: CSRMatrix):
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    return rows, csr.col_index.astype(np.int64), csr.values


def mixed_structure(M: int, nnz: int, *, band_frac: float = 0.2,
                    band_nnz_frac: float = 0.8, couple_frac: float = 0.005,
                    zipf_a: float = 2.2, seed: int = 0) -> CSRMatrix:
    """Mixed-structure matrix: dense-banded block ⊕ short-row sparse block.

    Rows [0, band_frac*M) form a *dense* FEM-style band (uniform,
    ~lane-width rows — the regular structure a padded ELL slab executes
    with almost no waste); rows [band_frac*M, M) form a scattered sparse
    block with zipf-skewed **row lengths** (webbase-like short rows, mean
    a few nnz) but *uniform column targets* — the structure where the
    nonzero-balanced segmented format wins and the 128-lane ELL/HYB slab
    floor loses, without introducing the hot *columns* that would make a
    global reordering the dominant fix.  A light random coupling
    (``couple_frac`` of nnz) keeps the matrix connected.  Under a
    contiguous row partition the two regimes land on *different shards*,
    which is exactly the case where one global kernel choice provably
    loses to per-shard selection (``benchmarks/hetero_bench.py``).
    """
    rng = np.random.default_rng(seed)
    hb = min(max(int(M * band_frac), 8), M - 8)
    n_band = int(nnz * band_nnz_frac)
    n_sp = max(nnz - n_band, 8)
    # Dense band: bandwidth sized so each row carries ~n_band/hb entries.
    bw = max(n_band // (2 * hb), 4)
    B1 = banded(hb, n_band, bw, seed=seed, scatter_frac=0.03)
    r1, c1, v1 = _to_coo(B1)
    # Sparse block: zipf row lengths (skewed), uniform scattered columns.
    m_sp = M - hb
    counts = np.minimum(rng.zipf(zipf_a, m_sp), m_sp)
    counts = np.maximum((counts * (n_sp / max(counts.sum(), 1))), 1.0)
    counts = counts.astype(np.int64)
    r2 = hb + np.repeat(np.arange(m_sp), counts)
    c2 = hb + rng.integers(0, m_sp, r2.shape[0])
    v2 = rng.standard_normal(r2.shape[0])
    n_cp = int(nnz * couple_frac)
    rows = np.concatenate([r1, r2, rng.integers(0, M, n_cp),
                           np.arange(M)])
    cols = np.concatenate([c1, c2, rng.integers(0, M, n_cp),
                           np.arange(M)])
    vals = np.concatenate([v1, v2, rng.standard_normal(n_cp), np.ones(M)])
    return csr_from_coo(rows, cols, vals, (M, M))


def blocked_band(M: int, nnz: int, *, band_frac: float = 0.75,
                 tiles_min: int = 1, tiles_max: int = 4, bm: int = 8,
                 bn: int = 128, seed: int = 0) -> CSRMatrix:
    """Blocked-band matrix: (8, 128)-aligned dense tiles ⊕ scattered rows.

    Rows [0, hb) are a *tile-aligned* band: each 8-row block carries
    between ``tiles_min`` and ``tiles_max`` fully dense (bm, bn) tiles
    placed along the diagonal — the structure the bitmask-tiled format
    stores with zero waste.  The per-block tile count *varies*, so the
    padded ELL slab pays the shard-wide max width (a 4-tile block widens
    every row's slab to 512) while tile pays only the occupied tiles;
    the nnz-balanced seg stream pays its scan/bookkeeping tax on rows
    that are perfectly regular.  Rows [hb, M) are a short-row scattered
    block (columns within the scattered range, so the two regimes land
    on different shards under a contiguous partition) where a stray
    nonzero would drag a whole 1024-cell tile in — the shards the
    per-shard selector must steer *away* from tile.  This is the
    ``hetero_bench --workload blocked`` headline matrix: the best
    tile-using per-shard program beats every tile-free program on the
    kernel-slot term.
    """
    rng = np.random.default_rng(seed)
    n_band = int(nnz * band_frac)
    per_tile = bm * bn
    avg_tiles = (tiles_min + tiles_max) / 2.0
    n_blk = int(min(max(n_band / (per_tile * avg_tiles), 1), M // bm))
    hb = n_blk * bm
    Nb = max(M // bn, 1)
    k = rng.integers(tiles_min, tiles_max + 1, n_blk)
    tb_row = np.repeat(np.arange(n_blk), k)
    offs = np.concatenate([np.arange(ki) for ki in k]) if n_blk else \
        np.zeros(0, np.int64)
    tb_col = np.clip((tb_row * bm) // bn + offs, 0, Nb - 1)
    T = tb_row.size
    lr = np.tile(np.repeat(np.arange(bm), bn), T)
    lc = np.tile(np.arange(bn), T * bm)
    r1 = np.repeat(tb_row * bm, per_tile) + lr
    c1 = np.repeat(tb_col * bn, per_tile) + lc
    v1 = rng.standard_normal(r1.size)
    m_sp = M - hb
    if m_sp > 0:
        kk = max((nnz - n_band) // m_sp, 1)
        r2 = hb + np.repeat(np.arange(m_sp), kk)
        c2 = hb + rng.integers(0, m_sp, r2.shape[0])
        v2 = rng.standard_normal(r2.shape[0])
    else:
        r2 = c2 = np.zeros(0, np.int64)
        v2 = np.zeros(0)
    rows = np.concatenate([r1, r2, np.arange(M)])
    cols = np.concatenate([c1, c2, np.arange(M)])
    vals = np.concatenate([v1, v2, np.ones(M)])
    return csr_from_coo(rows, cols, vals, (M, M))


def powerlaw_tail(M: int, nnz: int, *, n_monster: int = 8,
                  monster_frac: float = 0.5, seed: int = 0) -> CSRMatrix:
    """Power-law-tail matrix: a handful of *monster rows* ⊕ a uniform
    short-row background — the paper's §IV-D hot-spot distilled.

    Rows [0, n_monster) are fully dense (distinct columns across the
    whole width, so duplicate-summing cannot thin them) and together hold
    ~``monster_frac`` of the nnz budget; the remaining rows carry a
    uniform ~``(1-monster_frac)*nnz/(M-n_monster)`` nnz each.  Under a
    nonzero-balanced partition a shard ends up owning only a couple of
    monster rows — the degenerate case where the seg carry chain
    serializes and the split-nnz two-stage kernel is the cure
    (``benchmarks/hetero_bench.py --workload powerlaw_tail``).
    """
    rng = np.random.default_rng(seed)
    n_monster = max(min(n_monster, M // 4), 1)
    r1 = np.repeat(np.arange(n_monster, dtype=np.int64), M)
    c1 = np.tile(np.arange(M, dtype=np.int64), n_monster)
    v1 = rng.standard_normal(r1.shape[0])
    n_sp = max(int(nnz * (1.0 - monster_frac)), M)
    k = max(n_sp // max(M - n_monster, 1), 1)
    r2 = np.repeat(np.arange(n_monster, M, dtype=np.int64), k)
    c2 = rng.integers(0, M, r2.shape[0])
    v2 = rng.standard_normal(r2.shape[0])
    rows = np.concatenate([r1, r2, np.arange(M)])
    cols = np.concatenate([c1, c2, np.arange(M)])
    vals = np.concatenate([v1, v2, np.ones(M)])
    return csr_from_coo(rows, cols, vals, (M, M))


# name -> (M, nnz, builder)
PAPER_SUITE: Dict[str, tuple[int, int, Callable[..., CSRMatrix]]] = {
    "ford1":      (18_000,  100_000,
                   lambda M, nnz, seed: banded(M, nnz, max(M // 400, 4), seed=seed)),
    "cop20k_A":   (120_000, 2_600_000,
                   lambda M, nnz, seed: arrow_fem(M, nnz, seed=seed)),
    "webbase-1M": (1_000_000, 3_100_000,
                   lambda M, nnz, seed: powerlaw(M, nnz, seed=seed)),
    "rmat":       (445_000, 7_400_000,
                   lambda M, nnz, seed: rmat(M, nnz, seed=seed)),
    "nd24k":      (72_000, 28_700_000,
                   lambda M, nnz, seed: dense_blocks(M, nnz, seed=seed)),
    "audikw_1":   (943_000, 77_600_000,
                   lambda M, nnz, seed: banded(M, nnz, max(M // 100, 8), seed=seed)),
}


def make_matrix(name: str, *, scale: float = 1.0, seed: int = 0) -> CSRMatrix:
    """Build a suite matrix, optionally pattern-preserving scaled down."""
    M, nnz, builder = PAPER_SUITE[name]
    M = max(int(M * scale), 64)
    nnz = max(int(nnz * scale), 4 * M)
    return builder(M, nnz, seed)
