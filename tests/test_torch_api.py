"""The per-format kernel API of ``repro_torch.kernels`` against the
reference's ``repro.kernels``.

On the CPU every op runs its kernels' plain PyTorch versions.  Each op is
held to the reference op run with ``use_kernel=True, interpret=True``
(rtol = atol = 1e-4, the fp32 kernel paths) and to the reference's jnp
oracle (rtol = atol = 1e-5), on the reference tests' own problems; the
two new kernels' plain versions are held to their Pallas kernels in
interpret mode, and the port's torch oracles to the jnp oracles
(rtol = atol = 1e-5: the same arithmetic, summed in another order).
Batched columns must equal the per-vector call bitwise.
"""
import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as r_kernels
import repro.kernels.ops as r_ops
import repro.kernels.ref as r_ref
from repro.core.sparse_matrix import csr_from_coo, csr_to_bcsr as r_to_bcsr, \
    csr_to_ell
from repro.data.matrices import powerlaw_tail
from repro.kernels.spmv_split import split_psum as r_split_psum_pallas
from repro.kernels.spmv_tile import tile_walk_spmv as r_tile_walk_pallas

import repro_torch.kernels as t_kernels
import repro_torch.kernels.ops as t_ops
import repro_torch.kernels.ref as t_ref
from repro_torch.core import spmv as t_spmv
from repro_torch.core.sparse_matrix import CSRMatrix, csr_to_bcsr
from repro_torch.kernels import spmv_split, spmv_tile

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

KERNEL_TOL = 1e-4
ORACLE_TOL = 1e-5
CPU = dict(device="cpu")


def _port(A):
    return CSRMatrix(shape=A.shape, values=A.values, col_index=A.col_index,
                     row_ptr=A.row_ptr)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _columns_bitwise(fn, X):
    """fn(X) on an (N, B) block: every column equals fn(X[:, b]) exactly."""
    Y = fn(X)
    assert Y.shape[1] == X.shape[1]
    for b in range(X.shape[1]):
        assert torch.equal(Y[:, b], fn(np.ascontiguousarray(X[:, b])))


def rand_problem(M, N, nnz, seed=0):
    rng = np.random.default_rng(seed)
    A = csr_from_coo(rng.integers(0, M, nnz), rng.integers(0, N, nnz),
                     rng.standard_normal(nnz), (M, N))
    return A, rng.standard_normal(N).astype(np.float32)


def _block(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def monster():
    A = powerlaw_tail(1024, 8 * 1024, n_monster=4, seed=2)
    x = np.random.default_rng(2).standard_normal(1024).astype(np.float32)
    return A, x


def test_public_names_cover_the_reference():
    assert set(r_kernels.__all__) <= set(t_kernels.__all__)
    for name in r_kernels.__all__:
        assert callable(getattr(t_kernels, name))


def test_docstring_examples_run():
    result = doctest.testmod(t_kernels, verbose=False)
    assert result.failed == 0 and result.attempted > 0


def test_ell_and_hyb_match_reference(monster):
    A, x = monster
    ell = csr_to_ell(A)
    y = t_ops.ell_spmv(ell.data, ell.cols, x, **CPU)
    _close(y, r_ops.ell_spmv(ell.data, ell.cols, jnp.asarray(x),
                             interpret=True), KERNEL_TOL)
    _close(y, r_ops.ell_spmv_ref(ell.data, ell.cols, x), ORACLE_TOL)
    _columns_bitwise(lambda v: t_ops.ell_spmv(ell.data, ell.cols, v, **CPU),
                     _block(1024, 0))
    hyb = r_ops.hyb_from_csr(A)
    assert hyb.overflow_vals.size                     # the tail is real
    args = (hyb.data, hyb.cols, hyb.overflow_rows, hyb.overflow_cols,
            hyb.overflow_vals)
    y = t_ops.hyb_spmv(*args, x, **CPU)
    _close(y, r_ops.hyb_spmv(*args, jnp.asarray(x), use_kernel=True,
                             interpret=True), KERNEL_TOL)
    _close(y, r_ops.hyb_spmv(*args, jnp.asarray(x)), ORACLE_TOL)
    _columns_bitwise(lambda v: t_ops.hyb_spmv(*args, v, **CPU),
                     _block(1024, 1))


def test_hyb_takes_overflow_in_any_order(monster):
    """The reference's overflow add is a scatter: order-free."""
    A, x = monster
    hyb = r_ops.hyb_from_csr(A)
    perm = np.random.default_rng(0).permutation(hyb.overflow_vals.size)
    y = t_ops.hyb_spmv(hyb.data, hyb.cols, hyb.overflow_rows[perm],
                       hyb.overflow_cols[perm], hyb.overflow_vals[perm], x,
                       **CPU)
    _close(y, r_ops.hyb_spmv(hyb.data, hyb.cols, hyb.overflow_rows,
                             hyb.overflow_cols, hyb.overflow_vals,
                             jnp.asarray(x)), ORACLE_TOL)


def test_seg_matches_reference(monster):
    A, x = monster
    seg = t_ops.seg_from_csr(_port(A))
    rseg = r_ops.seg_from_csr(A)
    y = t_ops.seg_spmv(seg, x, **CPU)
    _close(y, r_ops.seg_spmv(rseg, jnp.asarray(x), use_kernel=True,
                             interpret=True), KERNEL_TOL)
    _close(y, r_ops.seg_spmv_ref(rseg.vals, rseg.cols, rseg.rows, x,
                                 num_rows=1024), ORACLE_TOL)
    raw = (seg.vals, seg.cols, seg.rows, seg.piece_chunk, seg.piece_lo,
           seg.piece_hi, seg.piece_row)
    assert torch.equal(t_ops.seg_spmv(raw, x, num_rows=1024, **CPU), y)
    with pytest.raises(ValueError, match="num_rows"):
        t_ops.seg_spmv(raw, x, **CPU)
    _columns_bitwise(lambda v: t_ops.seg_spmv(seg, v, **CPU), _block(1024, 2))


@pytest.mark.parametrize("ns", [2, 4])
def test_split_matches_reference(monster, ns):
    A, x = monster
    spl = t_ops.split_from_csr(_port(A), ns)
    rspl = r_ops.split_from_csr(A, ns)
    assert spl.num_splits == ns
    y = t_ops.split_spmv(spl, x, **CPU)
    _close(y, r_ops.split_spmv(rspl, jnp.asarray(x), use_kernel=True,
                               interpret=True), KERNEL_TOL)
    _close(y, r_ops.split_spmv_ref(rspl.vals, rspl.cols, rspl.rows, x,
                                   num_rows=1024), ORACLE_TOL)
    raw = (spl.vals, spl.cols, spl.rows, spl.piece_split, spl.piece_chunk,
           spl.piece_lo, spl.piece_hi, spl.piece_row)
    assert torch.equal(t_ops.split_spmv(raw, x, num_rows=1024, **CPU), y)
    _columns_bitwise(lambda v: t_ops.split_spmv(spl, v, **CPU),
                     _block(1024, 3))


@pytest.mark.parametrize("ns", [2, 4])
def test_split_flat_matches_reference(monster, ns):
    """The flattened slab and (P, 5) piece table, with padded piece rows
    ``[0, 1, 0, 0, 0]`` and the pieces shuffled (the reference's fix-up
    is a scatter, so their order is free)."""
    A, x = monster
    spl = r_ops.split_from_csr(A, ns)
    Cs, L = spl.chunks_per_split, spl.chunk
    pieces = np.stack([spl.piece_split * Cs + spl.piece_chunk, spl.piece_lo,
                       spl.piece_hi, spl.piece_row, spl.piece_split],
                      axis=1).astype(np.int32)
    pieces = np.concatenate([pieces, np.tile([[0, 1, 0, 0, 0]], (5, 1))])
    pieces = pieces[np.random.default_rng(ns).permutation(len(pieces))]
    flat = [a.reshape(ns * Cs, L) for a in (spl.vals, spl.cols, spl.rows)]
    y = t_ops.split_flat_spmv(*flat, pieces, x, num_rows=1024, num_splits=ns,
                              **CPU)
    _close(y, r_ops.split_flat_spmv(*flat, pieces, jnp.asarray(x),
                                    num_rows=1024, num_splits=ns,
                                    use_kernel=True, interpret=True,
                                    tile_c=Cs), KERNEL_TOL)
    _close(y, r_ops.split_flat_spmv(*flat, pieces, jnp.asarray(x),
                                    num_rows=1024, num_splits=ns),
           ORACLE_TOL)
    _columns_bitwise(lambda v: t_ops.split_flat_spmv(
        *flat, pieces, v, num_rows=1024, num_splits=ns, **CPU),
        _block(1024, 4))


@pytest.mark.parametrize("bm,bn", [(8, 128), (16, 128), (128, 128)])
def test_tile_matches_reference(bm, bn):
    A, x = rand_problem(256, 300, 3000, seed=1)       # 300 % 128 != 0
    t = t_ops.tile_from_csr(_port(A), bm=bm, bn=bn)
    rt = r_ops.tile_from_csr(A, bm=bm, bn=bn)
    y = t_ops.tile_spmv(t, x, **CPU)
    _close(y, r_ops.tile_spmv(rt, jnp.asarray(x), use_kernel=True,
                              interpret=True), KERNEL_TOL)
    _close(y, r_ops.tile_spmv(rt, jnp.asarray(x)), ORACLE_TOL)
    _columns_bitwise(lambda v: t_ops.tile_spmv(t, v, **CPU), _block(300, 5))


def test_tile_flat_matches_reference():
    """Flat operands with padding tiles (block row Rb) that must drop,
    given once in block-row order and once shuffled."""
    A, x = rand_problem(256, 256, 3000, seed=4)
    t = r_ops.tile_from_csr(A)
    Tn, Rb = t.num_tiles, -(-256 // t.bm)
    Tp = Tn + 3
    data = np.zeros((Tp, t.bm, t.bn), np.float32)
    data[:Tn] = t.data
    xcols = np.zeros((Tp, t.bn), np.int32)
    xcols[:Tn] = np.minimum(
        t.tile_cols[:, None] * t.bn + np.arange(t.bn)[None, :], 255)
    trows = np.full(Tp, Rb, np.int32)
    trows[:Tn] = t.tile_rows
    want = r_ops.tile_flat_spmv(data, xcols, trows, jnp.asarray(x),
                                num_rows=256, use_kernel=True, interpret=True)
    oracle = r_ops.tile_flat_spmv(data, xcols, trows, jnp.asarray(x),
                                  num_rows=256)
    perm = np.random.default_rng(0).permutation(Tp)
    for order in (np.arange(Tp), perm):
        args = (data[order], xcols[order], trows[order])
        y = t_ops.tile_flat_spmv(*args, x, num_rows=256, **CPU)
        _close(y, want, KERNEL_TOL)
        _close(y, oracle, ORACLE_TOL)
    _columns_bitwise(lambda v: t_ops.tile_flat_spmv(
        data, xcols, trows, v, num_rows=256, **CPU), _block(256, 6))


def test_bell_shims_warn_once_and_match_reference():
    from repro.core.spmv import _DEPRECATION_WARNED as r_warned
    A, x = rand_problem(256, 256, 2000, seed=2)
    for name in ("bell_from_bcsr", "bell_spmv", "bell_spmm"):
        t_spmv._DEPRECATION_WARNED.discard(name)
        r_warned.discard(name)
    with pytest.warns(DeprecationWarning, match="tile_from_csr"):
        blocks, bcols = t_ops.bell_from_bcsr(csr_to_bcsr(_port(A), (8, 128)))
    with pytest.warns(DeprecationWarning):
        rblocks, rbcols = r_ops.bell_from_bcsr(r_to_bcsr(A, (8, 128)))
    np.testing.assert_array_equal(blocks, rblocks)
    np.testing.assert_array_equal(bcols, rbcols)
    with pytest.warns(DeprecationWarning, match="tile_spmv"):
        y = t_ops.bell_spmv(blocks, bcols, x, **CPU)
    with pytest.warns(DeprecationWarning):
        want = r_ops.bell_spmv(rblocks, rbcols, jnp.asarray(x),
                               use_kernel=True, interpret=True)
    _close(y, want, KERNEL_TOL)
    _close(y, r_ref.bell_spmv_ref(rblocks, rbcols, jnp.asarray(x)),
           ORACLE_TOL)
    X = _block(256, 7)
    with pytest.warns(DeprecationWarning, match="tile_spmv"):
        Y = t_ops.bell_spmm(blocks, bcols, X, **CPU)
    _close(Y, r_ref.bell_spmm_ref(rblocks, rbcols, jnp.asarray(X)),
           ORACLE_TOL)
    with pytest.warns(DeprecationWarning):
        _close(Y, r_ops.bell_spmm(rblocks, rbcols, jnp.asarray(X),
                                  use_kernel=True, interpret=True),
               KERNEL_TOL)
    # once per process: the second calls are silent
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_ops.bell_from_bcsr(csr_to_bcsr(_port(A), (8, 128)))
        y2 = t_ops.bell_spmv(blocks, bcols, x, **CPU)
        Y2 = t_ops.bell_spmm(blocks, bcols, X, **CPU)
    assert torch.equal(y2, y) and torch.equal(Y2, Y)
    for b in range(3):
        assert torch.equal(Y[:, b], t_ops.bell_spmv(
            blocks, bcols, np.ascontiguousarray(X[:, b]), **CPU))


@pytest.mark.parametrize("ns", [2, 4])
def test_split_psum_plain_matches_pallas(monster, ns):
    A, x = monster
    spl = r_ops.split_from_csr(A, ns)
    got = spmv_split.split_psum(torch.from_numpy(spl.vals),
                                torch.from_numpy(spl.cols),
                                torch.from_numpy(x)[:, None])
    want = r_split_psum_pallas(spl.vals, spl.cols, jnp.asarray(x),
                               interpret=True)
    _close(got[0], want, ORACLE_TOL)
    _close(got[0], r_ref.split_psum_ref(spl.vals, spl.cols, x), ORACLE_TOL)


def _ragged_tiles(bm):
    """256 x 300 (300 % 128 != 0): block rows 4-9 empty, the others of
    uneven lengths, so every short row pads the Pallas walk table."""
    rng = np.random.default_rng(9)
    n = 2500
    rows = rng.integers(0, 256, n)
    rows = np.where((rows >= 32) & (rows < 80), rows + 48, rows)
    cols = np.minimum((rng.pareto(1.0, n) * 40).astype(int), 299)
    A = csr_from_coo(rows, cols, rng.standard_normal(n), (256, 300))
    return A, r_ops.tile_from_csr(A, bm=bm)


@pytest.mark.parametrize("bm", [8, 16])
def test_tile_walk_plain_matches_pallas(bm):
    A, t = _ragged_tiles(bm)
    counts = np.diff(t.tile_ptr)
    assert (counts == 0).any() and counts.min() < counts.max()
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    got = spmv_tile.tile_walk_spmv(
        torch.from_numpy(t.data), torch.from_numpy(t.tile_cols),
        torch.from_numpy(t.tile_ptr), torch.from_numpy(x)[:, None])
    c, tid, bc = r_ops._tile_walk_tables(t)
    xp = np.zeros(3 * 128, np.float32)
    xp[:300] = x
    want = r_tile_walk_pallas(t.data, c, tid, bc, jnp.asarray(xp),
                              interpret=True)
    _close(got[0], want, ORACLE_TOL)
    assert not got[0].reshape(-1, bm)[counts == 0].any()


def test_empty_matrices_give_zeros():
    E = CSRMatrix(shape=(16, 16), values=np.zeros(0),
                  col_index=np.zeros(0, np.int32),
                  row_ptr=np.zeros(17, np.int64))
    x = np.ones(16, np.float32)
    for ns in (1, 4, 999):
        spl = t_ops.split_from_csr(E, ns)
        assert spl.num_splits == 1                 # clamped to C == 1
        y = t_ops.split_spmv(spl, x, **CPU)
        assert y.shape == (16,) and not y.any()
    t = t_ops.tile_from_csr(E)
    assert t.num_tiles == 0
    y = t_ops.tile_spmv(t, x, **CPU)
    assert y.shape == (16,) and not y.any()
    y = t_ops.seg_spmv(t_ops.seg_from_csr(E), x, **CPU)
    assert y.shape == (16,) and not y.any()


def test_torch_oracles_match_reference_oracles(monster):
    A, x = monster
    X = _block(1024, 8)
    ell = csr_to_ell(A, max_width=128)
    seg = r_ops.seg_from_csr(A)
    spl = r_ops.split_from_csr(A, 4)
    tl = r_ops.tile_from_csr(A)
    orow, ocol, oval = (ell.overflow_rows, ell.overflow_cols,
                        ell.overflow_vals)
    psum = r_ref.split_psum_ref(spl.vals, spl.cols, x)
    pargs = (spl.piece_split, spl.piece_chunk, spl.piece_lo, spl.piece_hi,
             spl.piece_row)
    flat_x = np.minimum(tl.tile_cols[:, None] * 128 + np.arange(128), 1023)
    blocks, bcols = r_ops.bell_from_bcsr(r_to_bcsr(A, (8, 128)))
    cases = {
        "ell_spmv_ref": [(ell.data, ell.cols, v) for v in (x, X)],
        "coo_spmv_ref": [(orow, ocol, oval, x, 1024)],
        "seg_spmv_ref": [(seg.vals, seg.cols, seg.rows, v, 1024)
                         for v in (x, X)],
        "seg_psum_ref": [(seg.vals, seg.cols, x)],
        "split_psum_ref": [(spl.vals, spl.cols, x)],
        "split_partial_ref": [(np.array(psum), *pargs, 4, 1024)],
        "split_combine_ref": [(np.array(psum)[:, 0],)],
        "split_spmv_ref": [(spl.vals, spl.cols, spl.rows, v, 1024)
                           for v in (x, X)],
        "tile_spmv_ref": [(tl.data, tl.tile_rows, tl.tile_cols, v, 1024)
                          for v in (x, X)],
        "tile_flat_spmv_ref": [(tl.data, flat_x.astype(np.int32),
                                tl.tile_rows, v, 1024) for v in (x, X)],
        "bell_spmv_ref": [(blocks, bcols, x)],
        "bell_spmm_ref": [(blocks, bcols, X)],
    }
    assert set(cases) == set(r_ref.__all__)
    for name, calls in cases.items():
        for args in calls:
            got = getattr(t_ref, name)(*args)
            want = getattr(r_ref, name)(*(jnp.asarray(a) if isinstance(
                a, np.ndarray) else a for a in args))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=ORACLE_TOL, atol=ORACLE_TOL,
                                       err_msg=name)


def test_ops_without_device_raise_without_cuda(monkeypatch, monster):
    """Called without ``device=``, an op wants CUDA and raises where it is
    absent; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, x = monster
    seg = t_ops.seg_from_csr(_port(A))
    t = t_ops.tile_from_csr(_port(A))
    for call in (lambda: t_ops.seg_spmv(seg, x),
                 lambda: t_ops.split_spmv(t_ops.split_from_csr(_port(A), 2),
                                          x),
                 lambda: t_ops.tile_spmv(t, x),
                 lambda: t_ops.ell_spmv(np.zeros((8, 128), np.float32),
                                        np.zeros((8, 128), np.int32), x)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


FORMATS = {"seg": (t_ops.seg_from_csr, t_ops.seg_spmv),
           "split": (lambda A: t_ops.split_from_csr(A, 2), t_ops.split_spmv),
           "tile": (t_ops.tile_from_csr, t_ops.tile_spmv)}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_format_objects_keep_their_device_form(monkeypatch, monster, fmt):
    """A format object is converted once per device: a second call builds
    no piece table and reuses the same device arrays, and answers bitwise
    as the first.  A raw tuple is converted on every call."""
    A, x = monster
    build, op = FORMATS[fmt]
    obj = build(_port(A))
    tables = []
    piece_table = t_ops._piece_table
    monkeypatch.setattr(t_ops, "_piece_table", lambda *a: tables.append(1)
                        or piece_table(*a))
    first = op(obj, x, device="cpu")
    built = len(tables)
    assert built == (0 if fmt == "tile" else 1)
    (form,) = vars(obj)["_device_forms"].values()
    second = op(obj, _block(1024, 3), device="cpu")
    third = op(obj, x, device="cpu")
    assert len(tables) == built
    (again,) = vars(obj)["_device_forms"].values()
    assert all(a is b for a, b in zip(form, again))
    assert torch.equal(first, third) and second.shape == (1024, 3)
    if fmt == "seg":
        raw = (obj.vals, obj.cols, obj.rows, obj.piece_chunk, obj.piece_lo,
               obj.piece_hi, obj.piece_row)
        for _ in range(2):
            assert torch.equal(op(raw, x, num_rows=1024, device="cpu"),
                               first)
        assert len(tables) == built + 2
