"""rmat's stand-in: R-MAT with quadrant probabilities (a, b, c, 1 - a - b
- c), edges outside M dropped and duplicates summed (a frozen copy of
the program's ``data.matrices.rmat``)."""
import numpy as np

from benchlib.matrices import finish


def generate(M: int, nnz: int, *, a: float = 0.45, b: float = 0.22,
             c: float = 0.22, seed: int = 0, sort_device=None):
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
    return finish(rows[keep], cols[keep], vals[keep], M, False, sort_device)
