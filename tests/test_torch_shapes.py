"""Chunks over 1024 and tile shapes other than (8k, 128), against the
reference.

On the CPU the port's ops run their kernels' plain versions; each is held
to the reference op with ``use_kernel=True, interpret=True`` (rtol = atol
= 1e-4, as ``tests/test_torch_api.py``) and to float64 ``csr_matvec``
(2e-4 on |A|·|x|), at chunks 2048 and 4096 (``seg_spmv``, ``split_spmv``,
``split_flat_spmv``) and at tile shapes (8, 256), (16, 64), (4, 128),
(8, 64), (12, 40) (``tile_spmv``) and (16, 128), (12, 40)
(``tile_flat_spmv``), on ``powerlaw(1024, 8000, seed=5)``.  Batched
columns equal the per-vector call bitwise.

The CUDA kernels cannot run here, so the new launch geometry is emulated
in numpy from the sources' constants, as the redesign tests do:

* ``split_psum`` launches ``seg_psum``'s scan on the (1, NS*Cs, L) view of
  its slab, x as one shared (1, B, n) buffer: the launcher's arguments are
  read from the source, the plain versions agree bitwise on that view,
  and ``seg_psum``'s schedule on it is within 1e-5 (on |A|·|x|) of the
  Pallas ``split_psum`` in interpret mode at L = 2048 and 4096;
* the general tile walks (any shape the fast walks do not take): one warp
  per (block row, group of up to ``GROUP_ROWS`` rows), the last group cut
  where bm % ``GROUP_ROWS`` != 0; lane l takes cells l, l + 32, ... below
  bn in each tile in tile order, reads the mask byte j / 8 of each row
  (masked walk) or every cell (null-mask walk, ``tile_contrib``), adds in
  that order, and each row's lanes end in ``warp_sum``'s butterfly.  At
  bm = 4, 16 and bn = 8, 64, 256: every row is one warp's, every cell one
  lane's, each marked cell is added exactly once (unmarked cells hold
  NaN, so a read of one shows), and the sums are within 1e-5 of the
  Pallas ``tile_walk_spmv`` / ``tile_contrib`` (plus its block-row
  scatter) in interpret mode;
* ``tile_contrib``'s general launch: warps only for block rows below
  ``rb_used``, and fill blocks whose 4-byte stores zero the rows from
  ``rb_used * bm`` on exactly once, at odd bm too.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as r_ops
from repro.core.sparse_matrix import csr_from_coo, csr_matvec
from repro.data.matrices import powerlaw
from repro.kernels.spmv_split import split_psum as r_split_psum_pallas
from repro.kernels.spmv_tile import tile_walk_spmv as r_tile_walk_pallas

import repro_torch.kernels.ops as t_ops
from repro_torch.kernels import _lib, spmv_seg, spmv_split

from test_torch_api import _close, _columns_bitwise, _port
from test_torch_cuda import flat_tile_case
from test_torch_redesign import _fma, _within
from test_torch_seg_redesign import emulate_seg_psum

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

KERNEL_TOL = 1e-4          # the port's op against the reference's kernel op
SCHEDULE_TOL = 1e-5        # an emulated schedule against a Pallas kernel
E2E_TOL = 2e-4             # float32 against float64 csr_matvec
CPU = dict(device="cpu")
WARP = 32
_TILE = (_lib.CSRC / "spmv_tile.cu").read_text()
_COMMON = (_lib.CSRC / "common.cuh").read_text()


def _const(name, src=_TILE):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


GROUP_ROWS = _const("GROUP_ROWS")
WARPS_PER_BLOCK = _const("WARPS_PER_BLOCK")
FILL_STORES = _const("FILL_STORES")
RHS_CHUNK = _const("RHS_CHUNK", _COMMON)


@pytest.fixture(scope="module")
def problem():
    A = powerlaw(1024, 8000, seed=5)
    x = np.random.default_rng(2).standard_normal(1024).astype(np.float32)
    return A, x


def _block(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3)) \
        .astype(np.float32)


def _near_oracle(A, x, y):
    """|y - A x| <= 2e-4 (1 + |A| |x|), float64 ``csr_matvec``."""
    absA = dataclasses.replace(A, values=np.abs(A.values))
    _within(np.asarray(y), csr_matvec(A, x), csr_matvec(absA, np.abs(x)),
            E2E_TOL)


# --------------------------------------------------------------------------
# the ops at the new shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [2048, 4096])
def test_seg_long_chunks_match_reference(problem, chunk):
    A, x = problem
    seg = t_ops.seg_from_csr(_port(A), chunk=chunk)
    assert seg.vals.shape[1] == chunk
    y = t_ops.seg_spmv(seg, x, **CPU)
    _close(y, r_ops.seg_spmv(r_ops.seg_from_csr(A, chunk=chunk),
                             jnp.asarray(x), use_kernel=True, interpret=True),
           KERNEL_TOL)
    _near_oracle(A, x, y)
    _columns_bitwise(lambda v: t_ops.seg_spmv(seg, v, **CPU), _block(1024, 1))


@pytest.mark.parametrize("chunk", [2048, 4096])
def test_split_long_chunks_match_reference(problem, chunk):
    A, x = problem
    spl = t_ops.split_from_csr(_port(A), 2, chunk=chunk)
    assert spl.vals.shape[2] == chunk
    y = t_ops.split_spmv(spl, x, **CPU)
    _close(y, r_ops.split_spmv(r_ops.split_from_csr(A, 2, chunk=chunk),
                               jnp.asarray(x), use_kernel=True,
                               interpret=True), KERNEL_TOL)
    _near_oracle(A, x, y)
    _columns_bitwise(lambda v: t_ops.split_spmv(spl, v, **CPU),
                     _block(1024, 2))


@pytest.mark.parametrize("chunk", [2048, 4096])
def test_split_flat_long_chunks_match_reference(problem, chunk):
    A, x = problem
    spl = r_ops.split_from_csr(A, 2, chunk=chunk)
    ns, Cs, L = spl.vals.shape
    pieces = np.stack([spl.piece_split * Cs + spl.piece_chunk, spl.piece_lo,
                       spl.piece_hi, spl.piece_row, spl.piece_split],
                      axis=1).astype(np.int32)
    pieces = np.concatenate([pieces, np.tile([[0, 1, 0, 0, 0]], (3, 1))])
    flat = [a.reshape(ns * Cs, L) for a in (spl.vals, spl.cols, spl.rows)]

    def run(v):
        return t_ops.split_flat_spmv(*flat, pieces, v, num_rows=1024,
                                     num_splits=ns, **CPU)
    y = run(x)
    _close(y, r_ops.split_flat_spmv(*flat, pieces, jnp.asarray(x),
                                    num_rows=1024, num_splits=ns,
                                    use_kernel=True, interpret=True,
                                    tile_c=Cs), KERNEL_TOL)
    _near_oracle(A, x, y)
    _columns_bitwise(run, _block(1024, 3))


@pytest.mark.parametrize("bm,bn", [(8, 256), (16, 64), (4, 128), (8, 64),
                                   (12, 40)])
def test_tile_shapes_match_reference(problem, bm, bn):
    A, x = problem
    t = t_ops.tile_from_csr(_port(A), bm=bm, bn=bn)
    y = t_ops.tile_spmv(t, x, **CPU)
    _close(y, r_ops.tile_spmv(r_ops.tile_from_csr(A, bm=bm, bn=bn),
                              jnp.asarray(x), use_kernel=True,
                              interpret=True), KERNEL_TOL)
    _near_oracle(A, x, y)
    _columns_bitwise(lambda v: t_ops.tile_spmv(t, v, **CPU), _block(1024, 4))


def _flat_operands(t, n, pad=3):
    """The flat tile operands of a TileMatrix: ``pad`` padding tiles at
    block row Rb (zeros), lane positions clamped below n."""
    Tn = t.num_tiles
    data = np.zeros((Tn + pad, t.bm, t.bn), np.float32)
    data[:Tn] = t.data
    xcols = np.zeros((Tn + pad, t.bn), np.int32)
    xcols[:Tn] = np.minimum(t.tile_cols[:, None] * t.bn
                            + np.arange(t.bn)[None, :], n - 1)
    trows = np.full(Tn + pad, len(t.tile_ptr) - 1, np.int32)
    trows[:Tn] = t.tile_rows
    return data, xcols, trows


@pytest.mark.parametrize("bm,bn", [(16, 128), (12, 40)])
def test_tile_flat_shapes_match_reference(problem, bm, bn):
    A, x = problem
    args = _flat_operands(r_ops.tile_from_csr(A, bm=bm, bn=bn), 1024)

    def run(v):
        return t_ops.tile_flat_spmv(*args, v, num_rows=1024, **CPU)
    y = run(x)
    _close(y, r_ops.tile_flat_spmv(*args, jnp.asarray(x), num_rows=1024,
                                   use_kernel=True, interpret=True),
           KERNEL_TOL)
    _near_oracle(A, x, y)
    _columns_bitwise(run, _block(1024, 5))


# --------------------------------------------------------------------------
# split_psum as seg_psum's scan on the flattened slab
# --------------------------------------------------------------------------

def test_split_psum_launches_seg_psums_scan():
    split = (_lib.CSRC / "spmv_split.cu").read_text()
    seg = (_lib.CSRC / "spmv_seg.cu").read_text()
    body = split[split.index("RT_API int rt_split_psum("):]
    body = body[:body.index("\n}\n")]
    # one shard (the slab) of C = NS*Cs chunks, x shared (x_stride 0, Lx = n)
    assert "launch_seg_psum(vals, cols, x, 0, nullptr, 1, C, L, n, B, psum," \
        in body
    assert "const int sid = sids ? sids[k] : k;" in seg
    for src in (split, seg, _COMMON):
        assert not re.search(r"\b(block_inclusive_scan|split_psum_kernel)\b",
                             src)


@pytest.mark.parametrize("chunk", [512, 2048, 4096])
def test_split_psum_is_seg_psum_on_the_flat_view(problem, chunk):
    A, _ = problem
    spl = r_ops.split_from_csr(A, 2, chunk=chunk)
    NS, Cs, L = spl.vals.shape
    vals, cols = torch.from_numpy(spl.vals), torch.from_numpy(spl.cols)
    X = np.random.default_rng(6).standard_normal((3, 1024)).astype(np.float32)
    xb = torch.from_numpy(X)
    got = spmv_split.split_psum(vals, cols, xb)             # (B, NS, Cs, L)
    flat = spmv_seg.seg_psum_plain(
        vals.view(1, NS * Cs, L), cols.view(1, NS * Cs, L), xb[None],
        torch.zeros(1, dtype=torch.int32), torch.empty((1, 3, NS * Cs, L)))
    assert torch.equal(got, flat.view(3, NS, Cs, L))
    for b in range(3):                  # the kernel's order, column by column
        sched = emulate_seg_psum(spl.vals.reshape(NS * Cs, L),
                                 spl.cols.reshape(NS * Cs, L), X[b])
        want = r_split_psum_pallas(spl.vals, spl.cols, jnp.asarray(X[b]),
                                   interpret=True)
        scale = r_split_psum_pallas(np.abs(spl.vals), spl.cols,
                                    jnp.asarray(np.abs(X[b])),
                                    interpret=True)
        _within(sched.reshape(NS, Cs, L), want, scale, SCHEDULE_TOL)
        _within(got[b].numpy(), want, scale, SCHEDULE_TOL)


# --------------------------------------------------------------------------
# the general tile walks
# --------------------------------------------------------------------------

def test_general_walk_launch_matches_the_source():
    # the geometry walk_items and general_walk mirror
    launcher = _TILE[_TILE.index("RT_API int rt_tile_walk_spmv("):]
    assert "fast ? bm / 8 : (bm + GROUP_ROWS - 1) / GROUP_ROWS;" in launcher
    assert "const long long items = (long long)Mb * groups;" in launcher
    kernel = _TILE[_TILE.index("void tile_walk_general_kernel("):]
    for line in ("groups = (bm + GROUP_ROWS - 1) / GROUP_ROWS;",
                 "mb = (int)(item / groups), g = (int)(item % groups);",
                 "r0 = g * GROUP_ROWS, nr = min(GROUP_ROWS, bm - r0);"):
        assert line in kernel, line
    walk = _TILE[_TILE.index("__device__ __forceinline__ void general_walk("):]
    for line in ("for (long long t = lo; t < hi; ++t) {",
                 "for (int j = lane; j < c.bn; j += WARP) {",
                 "for (int i = 0; i < GROUP_ROWS; ++i) {"):
        assert line in walk, line


def walk_items(Mb, bm):
    """The general walks' warps in launch order: (mb, r0, nr), item =
    mb * groups + g, rows r0 = g * GROUP_ROWS .. r0 + nr - 1."""
    groups = -(-bm // GROUP_ROWS)
    out = []
    for item in range(Mb * groups):
        mb, g = divmod(item, groups)
        r0 = g * GROUP_ROWS
        out.append((mb, r0, min(GROUP_ROWS, bm - r0)))
    return out


def butterfly(p):
    """``warp_sum`` over the last axis (32 lanes): offsets 16, 8, 4, 2, 1,
    each lane adding its partner's value; returns lane 0's sum."""
    lane = np.arange(WARP)
    off = WARP // 2
    while off:
        p = (p + p[..., lane ^ off]).astype(np.float32)
        off //= 2
    return p[..., 0]


def general_walk(data, on_cell, xval, tiles, r0, nr, bn, visits):
    """One warp's walk (float32, one rounding a fused multiply-add): lane l
    takes cells l, l + 32, ... below bn of each tile in ``tiles`` in order;
    ``on_cell(t, rows, j)`` says which of the group's rows read cell j
    (False past the lane's last stride), ``xval(t, j)`` the x it meets.
    Returns each row's sum, and counts each cell read in ``visits``."""
    lane = np.arange(WARP)
    rows = np.arange(r0, r0 + nr)
    part = np.zeros((nr, WARP), np.float32)
    for t in tiles:
        for s in range(-(-bn // WARP)):
            j = s * WARP + lane
            jj = np.minimum(j, bn - 1)
            on = on_cell(t, rows, jj) & (j < bn)[None]
            d = np.where(on, data[t][rows[:, None], jj[None]], 0.0)
            xv = np.where(on.any(0), xval(t, jj), 0.0)
            part = np.where(on, _fma(part, d, xv[None]), part)
            i, l = np.nonzero(on)
            np.add.at(visits[t], (rows[i], jj[l]), 1)
    return butterfly(part)


def _walk_case(bm, bn):
    """``tile_from_csr`` of powerlaw(1000, 8000, seed=5) with every 7th
    entry a stored zero and rows 200-329 emptied (block rows without
    tiles); n = 1000 ends inside a block of 64 or 256 columns."""
    A = powerlaw(1000, 8000, seed=5)
    rows = np.repeat(np.arange(1000), np.diff(A.row_ptr))
    vals = A.values.copy()
    vals[::7] = 0.0
    keep = (rows < 200) | (rows >= 330)
    A = csr_from_coo(rows[keep], A.col_index[keep], vals[keep], A.shape)
    return r_ops.tile_from_csr(A, bm=bm, bn=bn), A.shape[1]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("bn", [8, 64, 256])
@pytest.mark.parametrize("bm", [4, 16])
def test_general_walk_schedule(bm, bn, masked):
    t, n = _walk_case(bm, bn)
    Mb, T = len(t.tile_ptr) - 1, t.num_tiles
    assert (np.diff(t.tile_ptr) == 0).any()
    bits = t.occupancy()
    assert (t.data[bits] == 0).any()                    # a stored zero
    # the masked walk never reads an unmarked cell: they hold NaN
    data = np.where(bits, t.data, np.nan) if masked else t.data
    x = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    cols = t.tile_cols.astype(np.int64)

    if masked:
        def on_cell(ti, rows, j):
            return bits[ti][rows[:, None], j[None]] \
                & (cols[ti] * bn + j < n)[None]

        def xval(ti, j):
            return x[np.minimum(cols[ti] * bn + j, n - 1)]
    else:
        def on_cell(ti, rows, j):
            return np.ones((len(rows), len(j)), bool)

        def xval(ti, j):
            c = cols[ti] * bn + j
            return np.where(c < n, x[np.minimum(c, n - 1)], 0.0)

    covered = np.zeros(Mb * bm, np.int64)
    visits = np.zeros((T, bm, bn), np.int64)
    y = np.zeros(Mb * bm, np.float32)
    for mb, r0, nr in walk_items(Mb, bm):
        assert 1 <= nr <= GROUP_ROWS
        covered[mb * bm + r0: mb * bm + r0 + nr] += 1
        tiles = range(int(t.tile_ptr[mb]), int(t.tile_ptr[mb + 1]))
        y[mb * bm + r0: mb * bm + r0 + nr] = general_walk(
            data, on_cell, xval, tiles, r0, nr, bn, visits)
    assert (covered == 1).all()
    in_x = (cols[:, None] * bn + np.arange(bn))[:, None, :] < n
    want_visits = bits & in_x if masked else np.ones_like(bits)
    np.testing.assert_array_equal(visits, want_visits.astype(np.int64))
    Nb = -(-n // bn)
    xp = np.zeros(Nb * bn, np.float32)
    xp[:n] = x
    c, tid, bc = r_ops._tile_walk_tables(t)
    want = r_tile_walk_pallas(t.data, c, tid, bc, jnp.asarray(xp),
                              interpret=True)
    scale = r_tile_walk_pallas(np.abs(t.data), c, tid, bc,
                               jnp.asarray(np.abs(xp)), interpret=True)
    _within(y, want, scale, SCHEDULE_TOL)


# --------------------------------------------------------------------------
# tile_contrib's general launch
# --------------------------------------------------------------------------

def test_general_contrib_launch_matches_the_source():
    body = _TILE[_TILE.index("int launch_contrib_general("):]
    body = body[:body.index("\n}\n")]
    for line in ("groups = (bm + GROUP_ROWS - 1) / GROUP_ROWS;",
                 "(long long)n_sids * rb_used * groups;",
                 "(items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;",
                 "nb = B < RHS_CHUNK ? B : RHS_CHUNK;",
                 "(long long)n_sids * nb * (Rb - rb_used) * bm;",
                 "(long long)WARPS_PER_BLOCK * WARP * FILL_STORES;",
                 "(fill + per_block - 1) / per_block;"):
        assert line in body, line
    launcher = _TILE[_TILE.index("RT_API int rt_tile_spmv("):]
    assert "if (BM != 8 || BN != 128)\n    return launch_contrib_general(" \
        in launcher


def contrib_launch(n_sids, Rb, rb_used, B, bm):
    """``launch_contrib_general``'s grid, per column chunk: the warps' items
    (k, mb, r0, nr) and the fill stores' (k, b, row), in launch order."""
    groups = -(-bm // GROUP_ROWS)
    items = n_sids * rb_used * groups
    tile_blocks = -(-items // WARPS_PER_BLOCK)
    fill = n_sids * min(B, RHS_CHUNK) * (Rb - rb_used) * bm
    fill_blocks = -(-fill // (WARPS_PER_BLOCK * WARP * FILL_STORES))
    threads = WARPS_PER_BLOCK * WARP
    R, per = Rb * bm, (Rb - rb_used) * bm
    out = []
    for b0 in range(0, B, RHS_CHUNK):                   # grid.y
        nb = min(RHS_CHUNK, B - b0)
        warps = []
        for it in range(tile_blocks * WARPS_PER_BLOCK):
            if it >= items:
                continue
            k, rem = divmod(it, rb_used * groups)
            mb, g = divmod(rem, groups)
            r0 = g * GROUP_ROWS
            warps.append((k, mb, r0, min(GROUP_ROWS, bm - r0)))
        total = n_sids * nb * per
        step = fill_blocks * threads
        stores = []
        for thread in range(step):                      # grid-stride loop
            for q in range(thread, total, step):
                kb, off = divmod(q, per)
                k, b = divmod(kb, nb)
                stores.append((k, b0 + b, R - per + off))
        out.append((b0, nb, warps, stores))
    return out


@pytest.mark.parametrize("n_sids,Rb,rb_used,B,bm", [
    (3, 40, 34, 11, 5),          # odd bm: rows from rb_used * 5 on
    (2, 17, 17, 3, 12),          # rb_used = Rb: no fill
    (2, 50, 0, 9, 4),            # no tiles: fill only
    (3, 300, 26, 1, 16),
])
def test_general_contrib_launch_covers_once(n_sids, Rb, rb_used, B, bm):
    R = Rb * bm
    rows = np.zeros((n_sids, B, R), np.int64)
    for b0, nb, warps, stores in contrib_launch(n_sids, Rb, rb_used, B, bm):
        for k, mb, r0, nr in warps:
            assert mb < rb_used and 1 <= nr <= GROUP_ROWS
            rows[k, b0:b0 + nb, mb * bm + r0: mb * bm + r0 + nr] += 1
        for k, b, row in stores:
            assert row >= rb_used * bm
            rows[k, b, row] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("bm,bn", [(4, 8), (4, 64), (4, 256), (16, 8),
                                   (16, 64), (16, 256), (5, 40)])
def test_general_contrib_schedule(bm, bn):
    # flat_tile_case's shards: padding tiles hold NaN, shard 1 has no
    # tiles, rb_used < Rb, and shard 3 is not listed
    t, n = _walk_case(bm, bn)
    data, xcol, brow, ptr, x, sids, rb_used, Rb = (
        v.numpy() if isinstance(v, torch.Tensor) else v
        for v in flat_tile_case(t, n, 1))
    x = x[0, 0]
    y = np.full((4, Rb * bm), np.nan, np.float32)
    visits = np.zeros(data.shape, np.int64)
    (_, _, warps, stores), = contrib_launch(len(sids), Rb, rb_used, 1, bm)
    for k, mb, r0, nr in warps:
        s = sids[k]
        tiles = range(int(ptr[s, mb]), int(ptr[s, mb + 1]))
        y[s, mb * bm + r0: mb * bm + r0 + nr] = general_walk(
            data[s], lambda t, rows, j: np.ones((len(rows), len(j)), bool),
            lambda t, j, s=s: x[xcol[s, t, j]], tiles, r0, nr, bn,
            visits[s])
    for k, _, row in stores:
        y[sids[k], row] = 0.0
    assert not visits[3].any() and np.isnan(y[3]).all()
    for s in sids:
        real = brow[s] < Rb                            # every real cell once
        assert (visits[s][real] == 1).all() and not visits[s][~real].any()
        if not real.any():                  # shard 1: zeros, from the fill
            assert not y[s].any()
            continue
        want, scale = (r_ops.tile_flat_spmv(
            d, xcol[s][real], brow[s][real], jnp.asarray(v),
            num_rows=Rb * bm, use_kernel=True, interpret=True)
            for d, v in ((data[s][real], x),
                         (np.abs(data[s][real]), np.abs(x))))
        _within(y[s], want, scale, SCHEDULE_TOL)
        assert not y[s, rb_used * bm:].any()
