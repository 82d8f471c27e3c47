"""The port's host copies are bitwise-equal to the reference's.

Formats, partition, layout, every reordering, ``split_meta``, the
generators, ``lower``'s stage arrays, the exchange tables and the device
operands: the same inputs (made with numpy from a seed) go through
``repro`` and ``repro_torch`` and every array must match exactly, dtype
included.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.layout as r_layout
import repro.core.partition as r_partition
import repro.core.plan as r_plan
import repro.core.program as r_program
import repro.core.reorder as r_reorder
import repro.core.sparse_matrix as r_sm
import repro.data.matrices as r_mat
import repro.kernels.ops as r_ops
from repro.core.emu import EmuConfig
from repro.core.spmv import SpmvPlan as RPlan

import repro_torch.core.layout as t_layout
import repro_torch.core.partition as t_partition
import repro_torch.core.plan as t_plan
import repro_torch.core.program as t_program
import repro_torch.core.reorder as t_reorder
import repro_torch.core.sparse_matrix as t_sm
import repro_torch.data.matrices as t_mat
import repro_torch.kernels.ops as t_ops
from repro_torch.core.spmv import SpmvPlan as TPlan


def assert_same(a, b, path="") -> None:
    """Recursive exact equality over dataclasses, tuples, dicts, arrays."""
    if dataclasses.is_dataclass(a):
        fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
        fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        assert fa.keys() <= fb.keys(), path
        for k in fa:
            assert_same(fa[k], fb[k], f"{path}.{k}")
    elif isinstance(a, dict):
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{path}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _to_port(A):
    return t_sm.CSRMatrix(shape=A.shape, values=A.values,
                          col_index=A.col_index, row_ptr=A.row_ptr)


GENERATORS = {
    "mixed_structure": lambda: r_mat.mixed_structure(256, 256 * 6, seed=0),
    "blocked_band": lambda: r_mat.blocked_band(512, 512 * 24, seed=1),
    "powerlaw_tail": lambda: r_mat.powerlaw_tail(2048, 2048 * 8, n_monster=2,
                                                 seed=2),
    "halo_spikes": lambda: r_mat.halo_spikes(512, 512 * 8, seed=3),
    "cop20k_A": lambda: r_mat.make_matrix("cop20k_A", scale=0.004, seed=4),
}


@pytest.fixture(scope="module", params=sorted(GENERATORS))
def matrix(request):
    A = GENERATORS[request.param]()
    return A, _to_port(A)


@pytest.mark.parametrize("name", sorted(r_mat.PAPER_SUITE))
def test_suite_generators_bitwise(name):
    scale = 64 / r_mat.PAPER_SUITE[name][0] * 4
    assert_same(r_mat.make_matrix(name, scale=scale, seed=5),
                t_mat.make_matrix(name, scale=scale, seed=5))


@pytest.mark.parametrize("gen,args", [
    ("banded", (300, 3000, 6)), ("arrow_fem", (300, 4000)),
    ("powerlaw", (300, 2000)), ("rmat", (300, 3000)),
    ("dense_blocks", (300, 6000)), ("mixed_structure", (300, 2000)),
    ("blocked_band", (512, 20000)), ("powerlaw_tail", (300, 3000)),
    ("halo_spikes", (300, 3000))])
def test_generators_bitwise(gen, args):
    assert_same(getattr(r_mat, gen)(*args, seed=7),
                getattr(t_mat, gen)(*args, seed=7))


def test_formats_bitwise(matrix):
    A, B = matrix
    assert_same(r_sm.csr_to_ell(A), t_sm.csr_to_ell(B))
    assert_same(r_sm.csr_to_ell(A, max_width=128),
                t_sm.csr_to_ell(B, max_width=128))
    assert_same(r_ops.hyb_from_csr(A), t_ops.hyb_from_csr(B))
    assert_same(r_ops.seg_from_csr(A), t_ops.seg_from_csr(B))
    for ns in (1, 3, 8, 64):
        assert_same(r_ops.split_from_csr(A, ns), t_ops.split_from_csr(B, ns))
    assert_same(r_ops.tile_from_csr(A), t_ops.tile_from_csr(B))
    assert r_sm.hyb_cap_width(r_sm.csr_row_nnz(A)) == \
        t_sm.hyb_cap_width(t_sm.csr_row_nnz(B))
    x = np.random.default_rng(0).standard_normal((A.ncols, 2))
    assert_same(r_sm.csr_matvec(A, x), t_sm.csr_matvec(B, x))


def test_csr_from_coo_and_empty_formats_bitwise():
    rng = np.random.default_rng(11)
    r, c = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    v = rng.standard_normal(300)
    A = r_sm.csr_from_coo(r, c, v, (40, 40))
    B = t_sm.csr_from_coo(r, c, v, (40, 40))
    assert_same(A, B)
    E = r_sm.csr_from_coo([], [], [], (16, 16))
    F = t_sm.csr_from_coo([], [], [], (16, 16))
    for build in ("seg_from_csr", "hyb_from_csr", "tile_from_csr"):
        assert_same(getattr(r_ops, build)(E), getattr(t_ops, build)(F))
    assert_same(r_ops.split_from_csr(E, 4), t_ops.split_from_csr(F, 4))
    assert_same(r_sm.csr_to_bcsr(E), t_sm.csr_to_bcsr(F))
    assert t_ops.tile_from_csr(F).max_tiles_per_block_row == 0


@pytest.mark.parametrize("block", [None, (8, 128), (16, 128)])
def test_bcsr_and_tile_row_counts_bitwise(matrix, block):
    """Block CSR (default (128, 128) blocks) and the widest block row of
    the tile layout, as the reference builds them."""
    A, B = matrix
    args = () if block is None else (block,)
    ra, ta = r_sm.csr_to_bcsr(A, *args), t_sm.csr_to_bcsr(B, *args)
    assert_same(ra, ta)
    assert (ra.nblocks, ra.density_in_blocks) == \
        (ta.nblocks, ta.density_in_blocks)
    bm, bn = block or (8, 128)
    rt = r_ops.tile_from_csr(A, bm=bm, bn=bn)
    tt = t_ops.tile_from_csr(B, bm=bm, bn=bn)
    assert rt.max_tiles_per_block_row == tt.max_tiles_per_block_row > 0


@pytest.mark.parametrize("S", [1, 2, 4])
def test_partition_bitwise(matrix, S):
    A, B = matrix
    for strat in ("row", "nonzero", "nnz"):
        assert_same(r_partition.make_partition(A, S, strat),
                    t_partition.make_partition(B, S, strat))
    assert_same(r_partition.nnz_chunk_starts(A.nnz, 512),
                t_partition.nnz_chunk_starts(B.nnz, 512))


@pytest.mark.parametrize("kind", ["block", "cyclic"])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_layout_bitwise(kind, S):
    ra, ta = r_layout.make_layout(kind, 103, S), \
        t_layout.make_layout(kind, 103, S)
    assert_same(ra, ta)
    idx = np.arange(103)
    assert_same(ra.owner_of(idx), ta.owner_of(idx))
    assert_same(ra.local_index(idx), ta.local_index(idx))
    v = np.random.default_rng(S).standard_normal((103, 2))
    assert_same(ra.to_sharded(v), ta.to_sharded(v))
    assert_same(ra.from_sharded(ra.to_sharded(v)),
                ta.from_sharded(ta.to_sharded(v)))


@pytest.mark.parametrize("method", r_reorder.REORDERINGS)
def test_reorderings_bitwise(matrix, method):
    A, B = matrix
    assert t_reorder.REORDERINGS == r_reorder.REORDERINGS
    assert_same(r_reorder.reordering_permutation(A, method, seed=3, parts=4),
                t_reorder.reordering_permutation(B, method, seed=3, parts=4))


def test_split_meta_and_constants():
    assert t_plan.SPLIT_CORES == r_plan.SPLIT_CORES
    assert t_plan.SPLIT_CORES == EmuConfig().threads_per_nodelet
    assert t_plan.SPLIT_MIN_SPAN == r_plan.SPLIT_MIN_SPAN
    assert t_ops.SEG_CHUNK == r_ops.SEG_CHUNK
    assert (t_sm.ELL_LANE, t_sm.ELL_SUBLANE) == (r_sm.ELL_LANE,
                                                  r_sm.ELL_SUBLANE)
    rng = np.random.default_rng(0)
    for _ in range(300):
        nnz = int(rng.integers(0, 200_000))
        mr = int(rng.integers(0, nnz + 1))
        cores = int(rng.choice([1, 8, 64, 132]))
        assert r_plan.split_meta(nnz, mr, cores) == \
            t_plan.split_meta(nnz, mr, cores)


PLANS = [
    dict(kernel="ell"), dict(kernel="seg", reordering="bfs"),
    dict(kernel="hyb", layout="cyclic"),
    dict(kernel="split", distribution="row", reordering="metis"),
    dict(kernel="tile", exchange="allgather"),
    dict(kernel="seg", shard_kernels=("tile", "split", "hyb", "seg"),
         split_counts=(1, 4, 1, 1),
         shard_exchanges=("halo", "allgather", "halo", "allgather")),
    dict(kernel="ell", reordering="random", layout="cyclic",
         exchange="allgather"),
    dict(kernel="split", reordering="degree"),
]


@pytest.mark.parametrize("fields", PLANS, ids=lambda f: "-".join(
    str(v) if not isinstance(v, tuple) else "mixed" for v in f.values()))
def test_lower_and_device_operands_bitwise(matrix, fields):
    A, B = matrix
    S = 4
    rp = r_program.lower(A, RPlan(num_shards=S, **fields))
    tp = t_program.lower(B, TPlan(num_shards=S, **fields))
    assert_same(rp.stages, tp.stages)
    for name in ("rows_per_shard", "row_offset", "shard_traffic", "perm",
                 "traffic", "partition", "x_layout", "b_layout", "matrix"):
        assert_same(getattr(rp, name), getattr(tp, name), name)
    assert_same(r_program._halo_tables(rp), t_program._halo_tables(tp))
    assert_same(r_program._row_remote_flags(rp),
                t_program._row_remote_flags(tp))
    r_ops_ = r_program._device_operands(rp)
    t_ops_ = t_program._device_operands(tp)
    assert_same(r_ops_, t_ops_)


def test_program_from_reference_arrays(matrix):
    A, B = matrix
    fields = dict(kernel="seg", reordering="bfs", num_shards=2,
                  shard_kernels=("split", "tile"))
    rp = r_program.lower(A, RPlan(**fields))
    carried = t_program.program_from_arrays(
        shape=rp.matrix.shape, values=rp.matrix.values,
        col_index=rp.matrix.col_index, row_ptr=rp.matrix.row_ptr,
        starts=rp.partition.starts, plan=dataclasses.asdict(rp.plan),
        perm=rp.perm)
    own = t_program.lower(B, TPlan(**fields))
    assert_same(carried.stages, own.stages)
    assert_same(t_program._device_operands(carried),
                t_program._device_operands(own))
    assert_same(rp.stages, carried.stages)
