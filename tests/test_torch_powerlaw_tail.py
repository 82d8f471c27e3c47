"""The benchmark's powerlaw_tail configuration on the port, on the CPU.

At 65,536 rows (a sixteenth of the configuration's 2**20, with the same
eight dense rows): the configuration's plan lowers to split stages on
exactly the shards that hold the dense rows, with the split count
``split_meta`` gives; the eager executor's y is the float64 product's
within the configuration's own limit; the benchmark's frozen generator
is bitwise the program's; the split family's counters are their hand
counts a call (and silent without split shards); and the two readers of
``split_kb`` and ``split_roofline`` read what the counters and a trace
hold, and nothing from a program that counts nothing.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch.core.program as program
from repro_torch import tracing
from repro_torch.core.plan import split_meta
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data.matrices import powerlaw_tail

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "bench" / "configs" / "powerlaw_tail.json")
                    .read_text())
#: Rows at the test's size, and its nonzero budget as the configuration
#: sets it (two dense rows' worth a dense row: half the nonzeros dense).
M = 1 << 16
N_MONSTER = CONFIG["matrix"]["n_monster"]
NNZ = 2 * N_MONSTER * M


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def matrix():
    return powerlaw_tail(M, NNZ, n_monster=N_MONSTER,
                         monster_frac=CONFIG["matrix"]["monster_frac"],
                         seed=3)


@pytest.fixture(scope="module")
def prog(matrix):
    return program.lower(matrix, SpmvPlan(**CONFIG["plan"]))


def _bench():
    if str(REPO / "bench") not in sys.path:
        sys.path.insert(0, str(REPO / "bench"))


def _x(prog, B, seed=5):
    x = np.random.default_rng(seed).standard_normal(
        (M,) if B == 1 else (M, B))
    return x, torch.from_numpy(prog.x_to_device(x.astype(np.float32)))


def test_the_plan_splits_exactly_the_shards_with_dense_rows(matrix, prog):
    A = prog.matrix
    want = CONFIG["plan"]["shard_kernels"]
    assert prog.shard_kernels() == tuple(want)
    for st in prog.stages:
        r0, r1 = st.row_offset, st.row_offset + st.rows
        dense = r0 < N_MONSTER
        assert (st.kernel == "split") == dense, st.shard
        if dense:
            longest = int(np.diff(A.row_ptr[r0:r1 + 1]).max())
            assert longest == M                   # a dense row, whole
            ns = split_meta(st.nnz, longest)
            assert st.split.num_splits == ns == \
                CONFIG["plan"]["split_counts"][st.shard]
    split_rows = sum(st.rows for st in prog.stages if st.kernel == "split")
    assert split_rows > N_MONSTER                 # and some short rows


@pytest.mark.parametrize("B", [1, 3])
def test_eager_executor_matches_the_float64_product(matrix, prog, B):
    """Normwise, as the benchmark checks a run: the largest gap over the
    largest (|A| |x|) of a column, within the configuration's limit (its
    float32 sums run through 512-element chunks and a split's partials;
    the bfloat16 control reads 1e-5 and more)."""
    x, xs = _x(prog, B)
    run = program.make_program_spmv_fn(prog, device="cpu")
    y = program.gather_b(prog, run(xs)).reshape(M, -1).astype(np.float64)
    A = sp.csr_matrix((matrix.values, matrix.col_index, matrix.row_ptr),
                      shape=matrix.shape)
    X = x.astype(np.float32).astype(np.float64).reshape(M, -1)
    want, scale = A @ X, abs(A) @ np.abs(X)
    err = (np.abs(y - want).max(axis=0) / scale.max(axis=0)).max()
    assert err <= CONFIG["limit"]["norm_err"]


@pytest.mark.parametrize("seed", [0, 11, 2**33 + 5])
def test_the_frozen_generator_is_bitwise_the_programs(seed):
    _bench()
    from benchlib import matrices
    params = {k: v for k, v in CONFIG["matrix"].items()
              if k not in ("generator", "M", "nnz")}
    ours = matrices.generator("powerlaw_tail").generate(
        M, NNZ, seed=seed, sort_device="cpu", **params)
    theirs = powerlaw_tail(M, NNZ, seed=seed, **params)
    assert ours.shape == tuple(theirs.shape)
    for f in ("values", "col_index", "row_ptr"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("B", [1, 2])
def test_split_counters_are_the_hand_counts(matrix, prog, B):
    """A recorded call adds the split family's psum (n, B, C, L) in both
    passes, float32 (its fix-up writes y: no per-split partials), and its
    four shards' nonzeros, rows, x read (every column: the dense rows hold
    them all) and y written."""
    ops = program._device_operands(prog)
    run = program.make_program_spmv_fn(prog, device="cpu")
    _, xs = _x(prog, B)
    tracing.enable()
    run(xs)
    n, L = 4, ops["rem_seg_vals"].shape[2]
    assert ops["NS_rem"] == 64
    scratch = sum(4 * n * B * ops[p + "seg_vals"].shape[1] * L
                  for p in ("loc_", "rem_"))
    split = [st for st in prog.stages if st.kernel == "split"]
    r0, r1 = split[0].row_offset, split[-1].row_offset + split[-1].rows
    assert tracing.counter("spmv.calls") == 1
    assert tracing.counter("split.scratch_bytes") == scratch
    assert tracing.counter("split.nnz") == \
        int(matrix.row_ptr[r1] - matrix.row_ptr[r0])
    assert tracing.counter("split.rows") == r1 - r0
    assert tracing.counter("split.x_elems") == M * B
    assert tracing.counter("split.y_elems") == (r1 - r0) * B
    run(xs)                                   # the same again, a call
    assert tracing.counter("split.scratch_bytes") == 2 * scratch


def test_an_all_seg_plan_counts_no_split_scratch(matrix):
    plan = dict(CONFIG["plan"], shard_kernels=None, split_counts=None)
    prog = program.lower(matrix, SpmvPlan(**plan))
    assert set(prog.shard_kernels()) == {"seg"}
    run = program.make_program_spmv_fn(prog, device="cpu")
    tracing.enable()
    run(_x(prog, 1)[1])
    assert tracing.counter("spmv.calls") == 1
    for k in ("scratch_bytes", "nnz", "rows", "x_elems", "y_elems",
              "long_rows", "long_pieces", "long_runs"):
        assert tracing.counter("split." + k) == 0


def _reader(name):
    _bench()
    from benchlib import cell
    return cell.reader(name)


def test_the_split_readers_read_counters_and_trace():
    _bench()
    from benchlib import split_bound
    tracing.enable()
    for _ in range(4):                        # four calls, as an executor
        tracing.count("spmv.calls")
        for k, v in (("scratch_bytes", 5_000_000), ("nnz", 1000),
                     ("rows", 10), ("x_elems", 300), ("y_elems", 10)):
            tracing.count("split." + k, v)
    ops = [["seg_piece_sums_kernel<1>", 9.0],
           ["seg_psum_kernel<1>", 2e-6], ["seg_fixup_kernel<1, false>", 3e-6],
           ["split_combine_kernel", 1e-6], ["seg_fixup_kernel<1, true>", 7.0]]
    ctx = {"trace": {"device_ops": ops, "device_op_s": 16.0},
           "counters": {"traced_calls": 2}}
    assert _reader("split_kb")(ctx) == 5_000.0
    byts = 1000 * 8 + 11 * 4 + 300 * 4 + 10 * 4
    assert split_bound.split_bytes(1000, 10, 300, 10) == byts
    want = 100.0 * byts / 3.35e12 / (6e-6 / 2)
    assert _reader("split_roofline")(ctx) == pytest.approx(want, rel=1e-12)
    assert [split_bound.is_split_kernel(n) for n, _ in ops] == \
        [False, True, True, True, False]


def test_the_split_readers_are_silent_without_the_counters():
    """A program that counts nothing of the split family (one before the
    counters, or a plan without split shards) gives no reading."""
    tracing.enable()
    tracing.count("spmv.calls", 3)
    ctx = {"trace": {"device_ops": [["seg_psum_kernel<1>", 1e-3]],
                     "device_op_s": 1e-3},
           "counters": {"traced_calls": 3}}
    assert _reader("split_kb")(ctx) is None
    assert _reader("split_roofline")(ctx) is None
    assert _reader("split_roofline")({"trace": None,
                                      "counters": {"traced_calls": 3}}) \
        is None
