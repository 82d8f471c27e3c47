"""audikw_1's stand-in: a banded FEM-like pattern, ``scatter_frac`` of the
entries off-band, the diagonal always present (a frozen copy of the
program's ``data.matrices.banded``)."""
import numpy as np

from benchlib.matrices import finish

#: Parameters a rehearsal's scale shrinks with M and nnz.
SCALED = ("bandwidth",)


def generate(M: int, nnz: int, bandwidth: int, *, seed: int = 0,
             symmetric: bool = True, scatter_frac: float = 0.12,
             sort_device=None):
    rng = np.random.default_rng(seed)
    n = nnz if not symmetric else nnz // 2 + M
    rows = rng.integers(0, M, n)
    off = rng.integers(-bandwidth, bandwidth + 1, n)
    cols = rows + off
    n_sc = int(n * scatter_frac)
    if n_sc:
        cols[:n_sc] = rng.integers(0, M, n_sc)
    vals = rng.standard_normal(n)
    rows = np.concatenate([rows, np.arange(M)])
    cols = np.concatenate([cols, np.arange(M)])
    vals = np.concatenate([vals, np.ones(M)])
    return finish(rows, cols, vals, M, symmetric, sort_device)
