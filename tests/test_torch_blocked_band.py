"""The benchmark's blocked_band configuration on the port, on the CPU.

At its rehearsal size, 4,096 rows (1/64 of the configuration's 2**18,
with the same band share, tile shape and tiles a block): the band ends
at row M / 2 there as at the full size, so the row partition gives the
four tile shards band rows alone and the four ELL shards scattered rows
alone; the eager executor's y is the benchmark's float64 reference
product's within a float32 dot product's error bound a row; the
benchmark's frozen generator is bitwise the program's; the tile and ELL
families' counters are their hand counts a call (and silent without
such shards); and the readers of ``tile_roofline`` and ``ell_roofline``
read what the counters and a trace hold, and nothing from a program that
counts nothing.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core.program as program
from repro_torch import tracing
from repro_torch.core.partition import make_partition
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data.matrices import blocked_band

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "bench" / "configs" / "blocked_band.json")
                    .read_text())
FULL = CONFIG["matrix"]
PARAMS = {k: v for k, v in FULL.items()
          if k not in ("generator", "M", "nnz")}
#: The rehearsal size, as ``benchlib.matrices.make_matrix`` scales it.
SCALE = 1 / 64
M = int(FULL["M"] * SCALE)
NNZ = max(int(FULL["nnz"] * SCALE), 4 * M)
S = CONFIG["plan"]["num_shards"]


def _band_blocks(M: int, nnz: int) -> int:
    """The generator's count of tiled bm-row blocks, by its arithmetic."""
    per_tile = PARAMS["bm"] * PARAMS["bn"]
    avg = (PARAMS["tiles_min"] + PARAMS["tiles_max"]) / 2.0
    n_band = int(nnz * PARAMS["band_frac"])
    return int(min(max(n_band / (per_tile * avg), 1), M // PARAMS["bm"]))


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def matrix():
    return blocked_band(M, NNZ, seed=3, **PARAMS)


@pytest.fixture(scope="module")
def prog(matrix):
    return program.lower(matrix, SpmvPlan(**CONFIG["plan"]))


def _bench():
    if str(REPO / "bench") not in sys.path:
        sys.path.insert(0, str(REPO / "bench"))


def _x(prog, B, seed=5):
    x = np.random.default_rng(seed).standard_normal(
        (M,) if B == 1 else (M, B)).astype(np.float32)
    return x, torch.from_numpy(prog.x_to_device(x))


@pytest.mark.parametrize("size", ["full", "rehearsal"])
def test_the_band_ends_at_half_the_rows(size):
    m, nnz = (FULL["M"], FULL["nnz"]) if size == "full" else (M, NNZ)
    assert _band_blocks(m, nnz) == m // 16
    assert _band_blocks(m, nnz) * PARAMS["bm"] == m // 2


def test_the_row_partition_puts_tiles_and_scattered_rows_apart(matrix,
                                                               prog):
    """The generator's band really ends at M / 2 (a band row is whole
    tiles, a scattered row reads only the scattered range), and the row
    partition's shards 0-3, the plan's tile shards, hold band rows alone,
    4-7, its ELL shards, scattered rows alone."""
    A, hb = matrix, M // 2
    nnz_row = np.diff(A.row_ptr)
    assert (nnz_row[:hb] % PARAMS["bn"] == 0).all()
    assert (A.col_index[A.row_ptr[hb]:] >= hb).all()
    assert nnz_row[hb:].max() < PARAMS["bn"]
    part = make_partition(A, S, CONFIG["plan"]["distribution"])
    assert part.starts.tolist() == [p * M // S for p in range(S + 1)]
    assert prog.shard_kernels() == tuple(CONFIG["plan"]["shard_kernels"])
    for st in prog.stages:
        r0, r1 = st.row_offset, st.row_offset + st.rows
        band = r1 <= hb
        assert band or r0 >= hb, st.shard
        assert st.kernel == ("tile" if band else "ell")
    tiles = sum(st.tile.num_tiles for st in prog.stages
                if st.kernel == "tile")
    assert tiles * PARAMS["bm"] * PARAMS["bn"] == A.row_ptr[hb]  # all full


@pytest.mark.parametrize("B", [1, 3])
def test_eager_executor_matches_the_reference_product(matrix, prog, B):
    """Row by row against the benchmark's float64 reference product: a
    float32 dot product of n terms, each value rounded to float32 once (x
    is float32 already), in any order of additions, lies within (n + 1)
    units of 2**-24 of (|A| |x|) of its row; one unit more covers the
    float64 reference's own rounding.  Normwise, the configuration's
    limit holds too, as a run checks it."""
    _bench()
    from benchlib import matrices, reference
    csr = matrices.generator("blocked_band").generate(M, NNZ, seed=3,
                                                      **PARAMS)
    x, xs = _x(prog, B)
    run = program.make_program_spmv_fn(prog, device="cpu")
    y = torch.from_numpy(program.gather_b(prog, run(xs)).reshape(M, -1)
                         .astype(np.float64))
    ref = reference.Reference(csr, "cpu")
    X = torch.from_numpy(x.astype(np.float64).reshape(M, -1))
    want, scale = ref.matmul(X), ref.matmul(X, absolute=True)
    n = torch.from_numpy(np.diff(csr.row_ptr).astype(np.float64))[:, None]
    assert ((y - want).abs() <= (n + 2) * 2.0 ** -24 * scale).all()
    assert reference.norm_error(y, want, scale) <= \
        CONFIG["limit"]["norm_err"]


@pytest.mark.parametrize("seed", [0, 11, 2**33 + 5])
def test_the_frozen_generator_is_bitwise_the_programs(seed):
    _bench()
    from benchlib import matrices
    ours = matrices.generator("blocked_band").generate(
        M, NNZ, seed=seed, sort_device="cpu", **PARAMS)
    theirs = blocked_band(M, NNZ, seed=seed, **PARAMS)
    assert ours.shape == tuple(theirs.shape)
    for f in ("values", "col_index", "row_ptr"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("B", [1, 2])
def test_tile_and_ell_counters_are_the_hand_counts(matrix, prog, B):
    """A recorded call adds the band's nonzeros, rows, tiles (its distinct
    (row // bm, col // bn) pairs), distinct columns and rows to ``tile.*``
    and the scattered rows' to ``ell.*``, both passes together; x and y
    counts scale with B, the rest not."""
    A, hb = matrix, M // 2
    run = program.make_program_spmv_fn(prog, device="cpu")
    _, xs = _x(prog, B)
    tracing.enable()
    run(xs)
    band = slice(0, A.row_ptr[hb])
    rows = np.repeat(np.arange(M), np.diff(A.row_ptr))
    tiles = np.unique(rows[band] // PARAMS["bm"] * M
                      + A.col_index[band] // PARAMS["bn"]).size
    want = {
        "tile.nnz": A.row_ptr[hb], "tile.rows": hb, "tile.tiles": tiles,
        "tile.x_elems": np.unique(A.col_index[band]).size * B,
        "tile.y_elems": hb * B,
        "ell.nnz": A.nnz - A.row_ptr[hb], "ell.rows": M - hb,
        "ell.x_elems": np.unique(A.col_index[A.row_ptr[hb]:]).size * B,
        "ell.y_elems": (M - hb) * B,
        "split.nnz": 0, "split.scratch_bytes": 0,
    }
    assert tracing.counter("spmv.calls") == 1
    assert {k: tracing.counter(k) for k in want} == want
    run(xs)                                   # the same again, a call
    assert tracing.counter("tile.tiles") == 2 * tiles
    assert tracing.counter("ell.x_elems") == 2 * want["ell.x_elems"]


def test_an_all_seg_plan_counts_no_tile_or_ell(matrix):
    plan = dict(CONFIG["plan"], kernel="seg", shard_kernels=None)
    prog = program.lower(matrix, SpmvPlan(**plan))
    assert set(prog.shard_kernels()) == {"seg"}
    run = program.make_program_spmv_fn(prog, device="cpu")
    tracing.enable()
    run(_x(prog, 1)[1])
    assert tracing.counter("spmv.calls") == 1
    for fam in ("tile", "ell"):
        for k in ("nnz", "rows", "tiles", "x_elems", "y_elems"):
            assert tracing.counter(f"{fam}.{k}") == 0


def _reader(name):
    _bench()
    from benchlib import cell
    return cell.reader(name)


OPS = [["tile_contrib_kernel<1>", 3e-6], ["ell_spmv_kernel<1>", 5e-6],
       ["gather_rows_kernel<1>", 7.0], ["tile_walk_kernel<1>", 9.0],
       ["tile_contrib_general_kernel<1, float4, 2>", 1e-6]]


def test_the_tile_and_ell_readers_read_counters_and_trace():
    _bench()
    from benchlib import tile_bound
    tracing.enable()
    for _ in range(4):                        # four calls, as an executor
        tracing.count("spmv.calls")
        for k, v in (("tile.nnz", 2048), ("tile.tiles", 2),
                     ("tile.rows", 8), ("tile.x_elems", 256),
                     ("tile.y_elems", 8), ("ell.nnz", 1000),
                     ("ell.rows", 10), ("ell.x_elems", 300),
                     ("ell.y_elems", 10)):
            tracing.count(k, v)
    ctx = {"trace": {"device_ops": OPS, "device_op_s": 16.0},
           "counters": {"traced_calls": 2}}
    tile = 2048 * 4 + 2 * 8 + 256 * 4 + 8 * 4
    ell = 1000 * 8 + 11 * 4 + 300 * 4 + 10 * 4
    assert tile_bound.tile_bytes(2048, 2, 256, 8) == tile
    assert tile_bound.ell_bytes(1000, 10, 300, 10) == ell
    assert _reader("tile_roofline")(ctx) == \
        pytest.approx(100.0 * tile / 3.35e12 / (4e-6 / 2), rel=1e-12)
    assert _reader("ell_roofline")(ctx) == \
        pytest.approx(100.0 * ell / 3.35e12 / (5e-6 / 2), rel=1e-12)
    assert [tile_bound.is_tile_kernel(n) for n, _ in OPS] == \
        [True, False, False, False, True]
    assert [tile_bound.is_ell_kernel(n) for n, _ in OPS] == \
        [False, True, False, False, False]


@pytest.mark.parametrize("name", ["tile_roofline", "ell_roofline"])
def test_the_tile_and_ell_readers_are_silent_without_either(name):
    """A program that counts nothing of the family (one before the
    counters, or a plan without its shards) gives no reading, nor does a
    run without a trace or without the family's kernels in it."""
    tracing.enable()
    tracing.count("spmv.calls", 3)
    ctx = {"trace": {"device_ops": OPS, "device_op_s": 16.0},
           "counters": {"traced_calls": 3}}
    assert _reader(name)(ctx) is None
    fam = name.split("_")[0]
    tracing.count(fam + ".nnz", 3000)
    tracing.count(fam + ".tiles" if fam == "tile" else "ell.rows", 3)
    assert _reader(name)(ctx) is not None
    assert _reader(name)({"trace": None,
                          "counters": {"traced_calls": 3}}) is None
    other = {"trace": {"device_ops": [["seg_piece_sums_kernel<1>", 1e-3]],
                       "device_op_s": 1e-3},
             "counters": {"traced_calls": 3}}
    assert _reader(name)(other) is None
