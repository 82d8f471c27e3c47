"""The seg family's piece sums against the scan and fix-up they replace.

``seg_piece_sums`` stores each piece's prefix difference straight from
the per-chunk scan, and ``seg_piece_fixup`` sums a row's differences in
piece order; their plain versions must give ``seg_psum_plain`` then
``seg_fixup_plain`` (NS = 1) bitwise, on S-stacked operands padded as the
executor pads them.  The executor's ``seg_chunk_ptr`` must give each
chunk's range of a seg shard's real pieces.  Inputs are made with numpy
from a seed.
"""
import re

import numpy as np
import pytest
import torch

import repro_torch.core.program as t_program
from repro_torch.core.sparse_matrix import csr_from_coo
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data import matrices as mats
from repro_torch.kernels import _lib, ops, spmv_seg

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

L = 8                                   # elements a chunk
LONG_ROW = int(re.search(r"constexpr int LONG_ROW = (\d+);",
                         (_lib.CSRC / "spmv_seg.cu").read_text()).group(1))


def _matrix(lengths, ncols=256, *, seed=0, negative_zero_at=None):
    """A CSR matrix whose row r holds ``lengths[r]`` entries; with
    ``negative_zero_at`` the row of that index holds one entry of -2 in
    column 0, which x leaves 0, so its only product is -0."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r, n in enumerate(lengths):
        rows.append(np.full(n, r))
        cols.append(np.sort(rng.choice(ncols - 1, n, replace=False)) + 1
                    if r != negative_zero_at else np.zeros(n, int))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(rows.size)
    if negative_zero_at is not None:
        vals[rows == negative_zero_at] = -2.0
    return csr_from_coo(rows, cols, vals, (len(lengths), ncols))


def _lengths(kind):
    """Row lengths giving each kind of row at L = 8."""
    if kind == "empty_rows":
        return [0, 3, 0, 0, 2, 0, 5, 0, 0, 1, 0, 0]
    if kind == "one_piece_rows":
        return [1, 2, 3, 2, 1, 4, 3, 1, 2]
    if kind == "rows_over_two_chunks":
        return [6, 5, 7, 6, 9, 4]          # 6 | 2+3 | 3+4 | ...
    if kind == "hub_row":                  # 21 chunks: 21 pieces
        return [3, 2, 21 * L - 5, 1, 4]
    if kind == "padded":                   # shard 0's C and Pp pad shard 1
        return [2, 1, 3, 9, 12, 4]
    if kind == "negative_zero":            # row 1 starts chunk 1, reads -0
        return [8, 1, 3, 2]
    raise KeyError(kind)


def _stack(mats_, pad_pieces_in_table):
    """The seg operands of ``mats_``, one shard each, stacked and padded
    as the executor pads them (chunks and pieces past each shard's own,
    padded piece rows [0, 1, 0, 0, 0]); with ``pad_pieces_in_table`` two
    padded pieces also sit inside the tables, where the per-format API's
    sort puts them (row 0, chunk 0)."""
    segs = [ops.seg_from_csr(A, chunk=L, lane=L) for A in mats_]
    R = max(A.nrows for A in mats_)
    S, C = len(segs), max(s.vals.shape[0] for s in segs) + 8
    tables = []
    for s, A in zip(segs, mats_):
        t = np.stack([s.piece_chunk, s.piece_lo, s.piece_hi, s.piece_row,
                      np.zeros_like(s.piece_row)], 1)
        if pad_pieces_in_table:
            t = np.concatenate([t, [[0, 1, 0, 0, 0]] * 2]).astype(np.int32)
        pcs, _ = ops._piece_table("cpu", *t.T, L, A.nrows)
        tables.append(pcs.numpy())
    Pp = max(len(t) for t in tables) + 5
    vals = np.zeros((S, C, L), np.float32)
    cols = np.zeros((S, C, L), np.int32)
    pieces = np.tile(np.array([0, 1, 0, 0, 0], np.int32), (S, Pp, 1))
    ptr = np.zeros((S, R + 1), np.int32)
    cptr = np.zeros((S, C + 1), np.int32)
    for p, (s, t) in enumerate(zip(segs, tables)):
        vals[p, :s.vals.shape[0]] = s.vals
        cols[p, :s.vals.shape[0]] = s.cols
        pieces[p, :len(t)] = t
        ptr[p] = np.searchsorted(t[:, 3], np.arange(R + 1))
        cptr[p] = np.searchsorted(t[:, 0], np.arange(C + 1))
    return [torch.from_numpy(a) for a in (vals, cols, pieces, ptr, cptr)]


KINDS = ("empty_rows", "one_piece_rows", "rows_over_two_chunks", "hub_row",
         "padded", "negative_zero")


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("in_table", [False, True],
                         ids=["pads_past_the_table", "pads_in_the_table"])
@pytest.mark.parametrize("kind", KINDS)
def test_piece_sums_equal_the_scan_and_fixup(kind, in_table, B):
    lengths = _lengths(kind)
    nz = 1 if kind == "negative_zero" else None
    shards = [_matrix(lengths, negative_zero_at=nz),
              _matrix(lengths[:3] if kind == "padded" else lengths[::-1],
                      seed=1)]
    vals, cols, pieces, ptr, cptr = _stack(shards, in_table)
    S, C, _ = vals.shape
    R = ptr.shape[1] - 1
    x = np.random.default_rng(2).standard_normal((S, B, 256)) \
        .astype(np.float32)
    x[:, :, 0] = 0.0
    x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    sids = torch.tensor([1, 0], dtype=torch.int32)
    n_real = ptr[:, R]
    counts = ptr[0, 1:] - ptr[0, :-1]
    if kind == "empty_rows":
        assert (counts == 0).any()
    if kind == "rows_over_two_chunks":
        assert (counts == 2).sum() >= 3
    if kind == "hub_row":
        assert counts.max() > 10 * LONG_ROW
    if kind == "padded":                  # shard 1's chunks and pieces pad
        assert cptr[1, C] < cptr[0, C]
        assert (cptr[1, 1:] == cptr[1, C]).sum() > 8
    assert (n_real < pieces.shape[1]).all()

    psum = spmv_seg.seg_psum_plain(vals, cols, x, sids,
                                   torch.empty((2, B, C, L)))
    want = spmv_seg.seg_fixup_plain(psum, pieces, ptr, sids, sids,
                                    torch.full((S, B, R), float("nan")))
    d = spmv_seg.seg_piece_sums(vals, cols, x, pieces, cptr, sids,
                                out=torch.full((2, B, pieces.shape[1]),
                                               float("nan")))
    got = spmv_seg.seg_piece_fixup(d, ptr, sids,
                                   out=torch.full((S, B, R), float("nan")))
    assert torch.equal(got, want)
    assert not got.isnan().any()
    for k, sid in enumerate(sids.tolist()):     # written at real pieces only
        assert not d[k, :, :int(n_real[sid])].isnan().any()
        assert d[k, :, int(n_real[sid]):].isnan().all()
    if kind == "negative_zero":                   # row 1's one product: -0
        lone = int(ptr[0, 1])
        ch, lo = int(pieces[0, lone, 0]), int(pieces[0, lone, 1])
        assert lo == 0 and (vals[0, ch, 0] * x[0, 0]).signbit().all()
        assert (d[1, :, lone] == 0).all() and (got[0, :, 1] == 0).all()
        assert not got[0, :, 1].signbit().any()   # the sum from +0
    # the stacked op, with the operand and with the ranges built anew
    for chunk_ptr in (cptr, None):
        y = ops.seg_stacked(vals, cols, pieces, ptr, x, sids,
                            chunk_ptr=chunk_ptr,
                            out=torch.full((S, B, R), float("nan")))
        assert torch.equal(y, want)


def _programs():
    return {
        "banded": (mats.banded(2000, 2000 * 24, 200, seed=0),
                   SpmvPlan(num_shards=4, kernel="seg", exchange="halo")),
        "rmat": (mats.rmat(2000, 2000 * 8, seed=0),
                 SpmvPlan(num_shards=4, kernel="seg", reordering="random",
                          distribution="nonzero", shard_kernels=(
                              "seg", "split", "seg", "seg"))),
    }


@pytest.mark.parametrize("name", ["banded", "rmat"])
def test_chunk_ptr_matches_piece_chunk_on_the_executors_tables(name):
    A, plan = _programs()[name]
    ops_ = t_program._device_operands(t_program.lower(A, plan))
    kid = ops_["kid"]
    seg = t_program.PROGRAM_KERNELS.index("seg")
    for pre in ("loc_", "rem_"):
        pieces, ptr = ops_[pre + "seg_pieces"], ops_[pre + "piece_ptr"]
        cptr = ops_[pre + "seg_chunk_ptr"]
        S, C = ops_[pre + "seg_vals"].shape[:2]
        R = ptr.shape[1] - 1
        assert cptr.shape == (S, C + 1) and cptr.dtype == np.int32
        for p in range(S):
            if kid[p] != seg:                    # split shards: unread
                assert not cptr[p].any()
                continue
            n = int(ptr[p, R])
            chunk = pieces[p, :n, 0]
            assert cptr[p, 0] == 0 and cptr[p, C] == n
            for c in range(C):
                assert (chunk[cptr[p, c]:cptr[p, c + 1]] == c).all()
            np.testing.assert_array_equal(
                cptr[p], np.searchsorted(chunk, np.arange(C + 1)))
            np.testing.assert_array_equal(
                cptr[p], ops._chunk_ranges(torch.from_numpy(pieces),
                                           torch.from_numpy(ptr), C)[p])
        assert any(int(ptr[p, R]) for p in range(S) if kid[p] == seg)
