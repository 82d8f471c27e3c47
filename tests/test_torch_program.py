"""The whole slice on the CPU: the port's device executor against the
reference's float64 ``execute(..., backend="numpy")``, ``csr_matvec`` and,
with one shard, the reference device executor running the Pallas kernels
in interpret mode.  Pipeline on/off and batched columns are bitwise."""
import itertools

import jax
import numpy as np
import pytest
import torch

import repro.core.program as r_program
import repro.data.matrices as r_mat
from repro.core.sparse_matrix import csr_from_coo, csr_matvec
from repro.core.spmv import SpmvPlan as RPlan

import repro_torch.core.program as t_program
from repro_torch.core.sparse_matrix import CSRMatrix
from repro_torch.core.spmv import PLAN_EXCHANGES, PLAN_KERNELS
from repro_torch.core.spmv import SpmvPlan as TPlan

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 2e-4


def _port(A):
    return CSRMatrix(shape=A.shape, values=A.values, col_index=A.col_index,
                     row_ptr=A.row_ptr)


def _x(n, B=None, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if B is None else (n, B))


def _check(A, fields, *, batch=3):
    """Port (CPU device path) vs the reference numpy executor and the
    float64 oracle, single vector and (N, B) block; batched columns and
    pipeline on/off bitwise."""
    rp = r_program.lower(A, RPlan(**fields))
    tp = t_program.lower(_port(A), TPlan(**fields))
    X = _x(A.ncols, batch)
    Y = t_program.execute(tp, X, backend="device", device="cpu")
    for want in (csr_matvec(A, X), r_program.execute(rp, X)):
        np.testing.assert_allclose(Y, want, atol=TOL, rtol=TOL)
    y0 = t_program.execute(tp, X[:, 0], backend="device", device="cpu")
    np.testing.assert_array_equal(Y[:, 0], y0)
    xs = tp.x_to_device(np.asarray(X, np.float32))
    serial = t_program.make_program_spmv_fn(tp, device="cpu",
                                            pipeline=False)(xs)
    piped = t_program.make_program_spmv_fn(tp, device="cpu")(xs)
    assert torch.equal(serial, piped)
    np.testing.assert_allclose(t_program.execute(tp, X), r_program.execute(
        rp, X), rtol=0, atol=0)                   # host oracles agree exactly


A_MIXED = r_mat.mixed_structure(256, 256 * 6, seed=0)
KERNEL_CONFIGS = [(k, None) for k in PLAN_KERNELS] + [
    ("seg", ("ell", "seg", "hyb", "split")),
    ("tile", ("tile", "split", "tile", "ell")),
]


@pytest.mark.parametrize("kernel,sk", KERNEL_CONFIGS,
                         ids=lambda v: "-".join(v) if isinstance(v, tuple)
                         else str(v))
@pytest.mark.parametrize("exchange", PLAN_EXCHANGES)
@pytest.mark.parametrize("layout", ["block", "cyclic"])
@pytest.mark.parametrize("distribution", ["row", "nonzero"])
def test_grid_vs_reference(kernel, sk, exchange, layout, distribution):
    _check(A_MIXED, dict(num_shards=4, kernel=kernel, shard_kernels=sk,
                         exchange=exchange, layout=layout,
                         distribution=distribution, reordering="bfs"))


@pytest.mark.parametrize("exchanges",
                         list(itertools.product(PLAN_EXCHANGES, repeat=2)))
def test_per_shard_exchanges(exchanges):
    A = r_mat.halo_spikes(512, 512 * 8, seed=3)
    _check(A, dict(num_shards=4, kernel="seg",
                   shard_kernels=("tile", "split", "hyb", "seg"),
                   shard_exchanges=exchanges * 2))


#: The operands each kernel family's launch reads from a pass (without
#: the pass's ``loc_``/``rem_`` prefix).
READS = {
    "ell": {"ell_data", "ell_cols", "ovf_rows", "ovf_cols", "ovf_vals",
            "ovf_ptr", "ell_len"},
    "seg": {"seg_vals", "seg_cols", "seg_pieces", "piece_ptr",
            "seg_chunk_ptr"},
    "split": {"seg_vals", "seg_cols", "seg_pieces", "piece_ptr"},
    "tile": {"tile_data", "tile_xcol", "tile_brow", "tile_ptr"},
}
READS["hyb"] = READS["ell"]


def uploaded(families) -> set:
    """What an executor whose shards run ``families`` uploads:
    ``row_remote`` and, per pass, what their launches read."""
    return {"row_remote"} | {pre + k for pre in ("loc_", "rem_")
                             for f in families for k in READS[f]}


def _tail_8():
    """``powerlaw_tail.solve``'s plan on 2^15 rows: split at NS 64 on the
    shards with the dense rows (0-3), seg on 4-7."""
    return r_mat.powerlaw_tail(1 << 15, (1 << 15) * 16, n_monster=8,
                               seed=0), \
        dict(num_shards=8, kernel="seg", distribution="nonzero",
             exchange="halo", shard_kernels=("split",) * 4 + ("seg",) * 4,
             split_counts=(64,) * 4 + (1,) * 4)


UPLOAD_PLANS = {
    "seg": lambda: (A_MIXED, dict(num_shards=4, kernel="seg")),
    "powerlaw_tail": _tail_8,
    "hyb": lambda: (A_MIXED, dict(num_shards=4, kernel="hyb")),
    "tile": lambda: (A_MIXED, dict(num_shards=4, kernel="tile")),
    "mixed": lambda: (r_mat.halo_spikes(512, 512 * 8, seed=3), dict(
        num_shards=4, kernel="seg",
        shard_kernels=("tile", "split", "hyb", "seg"),
        shard_exchanges=("halo", "allgather", "halo", "allgather"))),
}


@pytest.mark.parametrize("name", list(UPLOAD_PLANS))
def test_executor_uploads_only_what_its_launches_read(name):
    """``run.operands`` is ``row_remote`` and the operands the launches of
    the program's families read, each the host operand bitwise; y stays
    the reference's, pipelined or not."""
    A, fields = UPLOAD_PLANS[name]()
    _check(A, fields)
    tp = t_program.lower(_port(A), TPlan(**fields))
    run = t_program.make_program_spmv_fn(tp, device="cpu")
    assert set(run.families) == set(tp.shard_kernels())
    assert set(run.operands) == uploaded(run.families)
    ops = t_program._device_operands(tp)
    for k, t in run.operands.items():
        np.testing.assert_array_equal(t.numpy(), ops[k])
    if name == "powerlaw_tail":
        assert [st.split.num_splits for st in tp.stages[:4]] == [64] * 4


@pytest.mark.parametrize("kernel", PLAN_KERNELS)
@pytest.mark.parametrize("S", [1, 2, 4])
def test_zero_nnz_shards(kernel, S):
    """Rows [0, 96) hold nothing: under a row split whole shards are
    empty, and under a nonzero split some shards get no rows."""
    rng = np.random.default_rng(5)
    n = 800
    rows = rng.integers(96, 192, n)
    cols = rng.integers(0, 192, n)
    A = csr_from_coo(rows, cols, rng.standard_normal(n), (192, 192))
    for dist in ("row", "nonzero"):
        _check(A, dict(num_shards=S, kernel=kernel, distribution=dist))


@pytest.mark.parametrize("kernel", PLAN_KERNELS)
def test_single_shard_vs_reference_device_executor(kernel):
    """One shard: the reference shard_map executor with the Pallas kernels
    in interpret mode gives the same y."""
    A = r_mat.powerlaw_tail(256, 256 * 8, n_monster=2, seed=1)
    fields = dict(num_shards=1, kernel=kernel)
    rp = r_program.lower(A, RPlan(**fields))
    tp = t_program.lower(_port(A), TPlan(**fields))
    x = _x(A.ncols)
    want = r_program.execute(rp, x, backend="shard_map",
                             mesh=jax.make_mesh((1,), ("model",)),
                             use_kernel=True, interpret=True)
    got = t_program.execute(tp, x, backend="device", device="cpu")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, csr_matvec(A, x), atol=TOL, rtol=TOL)


def test_executor_shapes_and_unported_paths():
    tp = t_program.lower(_port(A_MIXED), TPlan(num_shards=2, kernel="seg"))
    run = t_program.make_program_spmv_fn(tp, device="cpu")
    per = tp.x_layout.padded_length() // 2
    assert run(np.zeros((2, per), np.float32)).shape == (2, run.rows_out)
    assert run(np.zeros((2, per, 5), np.float32)).shape == \
        (2, run.rows_out, 5)
    with pytest.raises(ValueError):
        run(np.zeros((3, per), np.float32))
    assert t_program.execute(tp, backend="emu").ticks > 0
    assert all(a is b for a, b in zip(t_program.relower(tp, tp.plan).stages,
                                      tp.stages))
    assert isinstance(TPlan.auto(tp.matrix, num_shards=2, probe=0), TPlan)
    # the legacy stacked-slab views are the reference's, bitwise
    rp = r_program.lower(A_MIXED, RPlan(num_shards=2, kernel="seg"))
    for name in ("seg_vals", "seg_cols", "seg_rows", "seg_pieces", "data",
                 "cols"):
        want, got = getattr(rp, name), getattr(tp, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_graphs_need_cuda():
    """Graph replay is CUDA's: asked for on the CPU it raises, it never
    runs eagerly without saying so."""
    tp = t_program.lower(_port(A_MIXED), TPlan(num_shards=2, kernel="seg"))
    with pytest.raises(ValueError, match="graphs=True"):
        t_program.make_program_spmv_fn(tp, device="cpu", graphs=True)
    run = t_program.make_program_spmv_fn(tp, device="cpu")
    assert run.program is tp and run.graph_stats() == []
