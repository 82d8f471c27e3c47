"""powerlaw_tail: ``n_monster`` fully dense rows holding about
``monster_frac`` of the nonzeros over a uniform background of short rows,
the diagonal always present (a frozen copy of the program's
``data.matrices.powerlaw_tail``).  ``n_monster`` is a count of rows, not
a size: no rehearsal shrinks it."""
import numpy as np

from benchlib.matrices import csr_from_coo


def generate(M: int, nnz: int, *, n_monster: int = 8,
             monster_frac: float = 0.5, seed: int = 0, sort_device=None):
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
    return csr_from_coo(rows, cols, vals, (M, M), sort_device=sort_device)
