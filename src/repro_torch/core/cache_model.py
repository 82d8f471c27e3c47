"""Cache-hierarchy baseline (paper §IV-E, Fig. 12).

The paper contrasts Emu against a dual-socket Broadwell Xeon (45 MB LLC):
reorderings buy at most 12-16% there, and random *never* helps.  Two
baselines are provided:

1. ``measure_cpu_spmv`` — a *real measurement* on this container's CPU
   (a genuine cache-memory machine): CSR SpMV wall-time via numpy vectorized
   gather+segment-sum, averaged over trials, exactly the paper's metric
   (effective MB/s).
2. ``analytic_cache_model`` — the reasoning the paper gives: performance is
   governed by cache-line reuse of x; a miss costs ~100-200x an L1 hit, so
   locality (banding) helps modestly and random destroys it.
3. ``analytic_tile_cache_model`` — the same hierarchy walked by the
   bitmask-tiled format instead of the scalar CSR gather: x moves in
   lane-aligned ``bn``-element tiles (whole contiguous lines per
   occupied tile, reuse measured at tile granularity over the block-row-
   major walk) and the data stream carries **no colIndex companion** —
   at the price of walking every cell of every occupied tile, padding
   included.  On a banded matrix the tile walk's effective bandwidth
   beats the scalar gather's; on a scattered one the padded cells sink
   it — the cache-side mirror of the kernel-slot trade the per-shard
   selector makes.

The port's host copy of ``repro.core.cache_model`` (numpy only): the same
arithmetic, so its results equal the reference's bitwise.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .sparse_matrix import CSRMatrix, csr_row_nnz

__all__ = ["CpuSpmvResult", "measure_cpu_spmv", "analytic_cache_model",
           "analytic_tile_cache_model"]


@dataclasses.dataclass(frozen=True)
class CpuSpmvResult:
    seconds: float
    bandwidth_mbs: float
    gflops: float


def _csr_spmv_numpy(csr: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Row-segment CSR SpMV; gathers of x hit the cache hierarchy like the
    paper's C implementation (the access pattern, not the FLOPs, dominates).
    """
    contrib = csr.values * x[csr.col_index]
    # segment sum by row via reduceat (rows with zero nnz handled after)
    starts = csr.row_ptr[:-1]
    out = np.add.reduceat(np.concatenate([contrib, [0.0]]), np.minimum(starts, csr.nnz))
    out[csr_row_nnz(csr) == 0] = 0.0
    return out[: csr.nrows]


def measure_cpu_spmv(csr: CSRMatrix, *, trials: int = 10, warmup: int = 2) -> CpuSpmvResult:
    rng = np.random.default_rng(0)
    x = rng.standard_normal(csr.ncols)
    for _ in range(warmup):
        _csr_spmv_numpy(csr, x)
    t0 = time.perf_counter()
    for _ in range(trials):
        _csr_spmv_numpy(csr, x)
    dt = (time.perf_counter() - t0) / trials
    useful = 8.0 * (3 * csr.nnz + 2 * csr.nrows)
    return CpuSpmvResult(seconds=dt, bandwidth_mbs=useful / dt / 1e6,
                         gflops=2.0 * csr.nnz / dt / 1e9)


def analytic_cache_model(csr: CSRMatrix, *, line_elems: int = 8,
                         llc_bytes: int = 45 * 2**20,
                         hit_cycles: float = 4.0,
                         miss_cycles: float = 400.0,
                         clock_hz: float = 2.4e9) -> float:
    """Estimated bandwidth (MB/s) from x-reuse distance over cache lines.

    A load of x[j] hits if line j//line_elems was touched recently (within
    the LLC working window).  Streaming arrays (values/colIndex/b) are
    prefetch-friendly: 1/line_elems misses per element.
    """
    cols = csr.col_index // line_elems
    window = llc_bytes // 64
    last = {}
    misses = 0
    step = max(csr.nnz // 2_000_000, 1)      # sample for very large matrices
    sampled = cols[::step]
    for i, c in enumerate(sampled):
        prev = last.get(c)
        if prev is None or i - prev > window:
            misses += 1
        last[c] = i
    miss_rate = misses / max(sampled.size, 1)
    per_nnz = (2.0 / line_elems + 1.0) * hit_cycles + \
        miss_rate * miss_cycles + (1 - miss_rate) * hit_cycles
    cycles = csr.nnz * per_nnz
    seconds = cycles / clock_hz
    useful = 8.0 * (3 * csr.nnz + 2 * csr.nrows)
    return useful / seconds / 1e6


def analytic_tile_cache_model(csr: CSRMatrix, *, bm: int = 8, bn: int = 128,
                              line_elems: int = 8,
                              llc_bytes: int = 45 * 2**20,
                              hit_cycles: float = 4.0,
                              miss_cycles: float = 400.0,
                              clock_hz: float = 2.4e9) -> float:
    """Estimated bandwidth (MB/s) of the bitmask-tiled walk on the same
    hierarchy as :func:`analytic_cache_model` (same useful-byte metric,
    so the two numbers compare directly, Fig. 12-style).

    Two differences from the scalar CSR gather: (1) the data stream is
    pure — one value per walked cell, no colIndex element riding along —
    and prefetch-friendly at ``1/line_elems`` misses per cell; (2) x is
    touched one lane-aligned ``bn``-element tile at a time (whole
    contiguous cache lines), with reuse measured at *tile* granularity
    over the block-row-major occupied-tile walk — sequential streaming
    through a band re-touches the same few x tiles, where the scalar
    gather re-pays a reuse-distance check per nonzero.  The price is
    padding: every cell of every occupied tile is walked, so a
    scattered matrix (one nonzero per tile) walks ``bm * bn`` cells per
    nonzero and the effective bandwidth collapses — tile's loss case,
    exactly as in :func:`~repro_torch.core.plan.kernel_shard_costs`.
    """
    rows_of = np.repeat(np.arange(csr.nrows), csr_row_nnz(csr))
    Nb = max(-(-csr.ncols // bn), 1)
    key = (rows_of // bm).astype(np.int64) * Nb + csr.col_index // bn
    tiles = np.unique(key)                    # block-row-major walk order
    bcols = tiles % Nb
    window = llc_bytes // (bn * 8)            # x tiles resident in the LLC
    last: dict[int, int] = {}
    misses = 0
    for i, c in enumerate(bcols):
        prev = last.get(int(c))
        if prev is None or i - prev > window:
            misses += 1
        last[int(c)] = i
    T = max(tiles.size, 1)
    lines_per_tile = max(bn // line_elems, 1)
    x_cycles = lines_per_tile * (misses * miss_cycles
                                 + (T - misses) * hit_cycles)
    data_cycles = T * bm * bn / line_elems * hit_cycles
    b_cycles = 2.0 * csr.nrows / line_elems * hit_cycles
    seconds = (data_cycles + x_cycles + b_cycles) / clock_hz
    useful = 8.0 * (3 * csr.nnz + 2 * csr.nrows)
    return useful / seconds / 1e6
