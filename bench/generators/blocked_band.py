"""blocked_band: a band of fully dense (bm, bn) tiles, ``tiles_min`` to
``tiles_max`` of them a bm-row block along the diagonal, on the rows the
band's share of the nonzeros fills, over short scattered rows whose
columns lie in the scattered range, the diagonal always present (a
frozen copy of the program's ``data.matrices.blocked_band``).  The tile
shape and the tiles a block are shapes, not sizes: no rehearsal shrinks
them."""
import numpy as np

from benchlib.matrices import csr_from_coo


def generate(M: int, nnz: int, *, band_frac: float = 0.75,
             tiles_min: int = 1, tiles_max: int = 4, bm: int = 8,
             bn: int = 128, seed: int = 0, sort_device=None):
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
    return csr_from_coo(rows, cols, vals, (M, M), sort_device=sort_device)
