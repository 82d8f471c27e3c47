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
* the general tile walks (any shape the fast walks do not take), their
  layouts (``MaskLayout``, ``CellLayout``) and lane orders mirrored from
  the source and read from its constants: the masked walk (lane (u, r) of
  a warp of RG rows walks items u, u + TPS, ..., an item a tile row's
  piece of up to 128 columns, its mask bytes and then its marked cells in
  ascending column), the null-mask walk and ``tile_contrib``'s (lanes
  across (tile, row, cell), 4 cells a load where bn % 4 == 0, a warp at
  most ``GENERAL_ROWS`` rows), emulated warp by warp in float32, one
  rounding a fused multiply-add, each row's lanes ending in the kernel's
  butterfly.  At bm = 4, 5, 12, 16 and bn = 8, 16, 40, 64, 256 (the
  null-mask walk and ``tile_contrib`` also at bn = 6, 10 and 1, on
  ``csr_to_bcsr`` blocks): every marked cell is read exactly once
  (unmarked cells hold NaN, so a read of one shows), every mask byte
  once, every output row is
  written once, the sums of 11 columns (two column chunks) are within
  1e-5 (on |A|·|x|) of the walk in float64 and column 0 of the Pallas
  ``tile_walk_spmv`` / ``tile_contrib`` (plus its block-row scatter) in
  interpret mode, and batched columns equal the single-vector call
  bitwise;
* ``tile_contrib``'s general launch: warps only for block rows below
  ``rb_used``, and fill blocks whose 4-byte stores zero the rows from
  ``rb_used * bm`` on exactly once, at odd bm too.
"""
import dataclasses
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as r_ops
from repro.core.sparse_matrix import csr_from_coo, csr_matvec, csr_to_bcsr
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


GENERAL_GROUP = _const("GENERAL_GROUP")
GENERAL_ROWS = _const("GENERAL_ROWS")
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
    # one shard (the slab) of C = NS*Cs chunks, x shared (x_stride 0)
    assert "launch_seg_psum(vals, cols, x, 0, nullptr, 1, C, L, B, psum," \
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
    xb = torch.from_numpy(np.ascontiguousarray(X.T))         # (n, B)
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
    # the layouts and lane orders mask_layout, cell_layout, masked_walk
    # and cells_walk mirror
    for line in (
            "RG((bm & -bm) < GENERAL_GROUP ? (bm & -bm) : GENERAL_GROUP),",
            "TPS(WARP / RG), P((bn + 127) / 128), groups(bm / RG) {}",
            "V = bn % 4 == 0 ? 4 : 1;", "CV = bn / V;",
            "LR = pow2_ceil(CV < WARP ? CV : WARP);",
            "NC = (CV + LR - 1) / LR;", "int rows = pow2_ceil(bm);",
            "if (rows > GENERAL_ROWS) rows = GENERAL_ROWS;",
            "RS = WARP / LR < rows ? WARP / LR : rows;",
            "TPS = WARP / (LR * RS);",
            "const int per = pow2_ceil((bm + RS - 1) / RS);",
            "RPL = per < GENERAL_ROWS / RS ? per : GENERAL_ROWS / RS;",
            "G = RS * RPL;", "groups = (bm + G - 1) / G;"):
        assert line in _TILE, line
    masked = _body("void tile_walk_general_kernel(")
    for line in (
            "mb = (int)(item / L.groups), g = (int)(item % L.groups);",
            "r = lane % L.RG, u = lane / L.RG, row = g * L.RG + r;",
            "const int items = (tile_ptr[mb + 1] - lo) * L.P;",
            "for (int k0 = u; k0 < items; k0 += L.TPS * S) {",
            "const int k = k0 + L.TPS * s;",
            "const int t = lo + (L.P == 1 ? k : k / L.P);",
            "const int p = L.P == 1 ? 0 : k % L.P;",
            "load_mask_piece(mask + tr * MB + 16 * p, min(16, MB - 16 * p),",
            "xc[s] = (long long)tile_cols[t] * bn + 128 * p;",
            "for (int off = L.RG; off < WARP; off *= 2)",
            "if (u == 0) {"):
        assert line in masked, line
    walk = _body("__device__ __forceinline__ void cells_walk(")
    for line in (
            "const int v = lane % L.LR, r = (lane / L.LR) % L.RS;",
            "const int u = lane / (L.LR * L.RS), r0 = g * L.G + r;",
            "const int items = (hi - lo) * L.NC;",
            "return (L.NC == 1 ? 0 : k % L.NC) * L.LR + v; };",
            "t = lo + (L.NC == 1 ? k : k / L.NC), w = load_of(k);",
            "d[i] = c.load(t, r0 + L.RS * i, w);",
            "for (int k0 = u; k0 < items; k0 += L.TPS * GP) {",
            "if (load_of(k) < L.CV) {",
            "part[i][b] = fmaf(cell(d[i], j), xv[j][b], part[i][b]);"):
        assert line in walk, line
    # R, the rows a lane keeps sums for, is the layout's RPL
    for line in ("launch_dense_walk<NB, 4>(CellLayout(bm, bn).RPL,",
                 "launch_contrib_cells<4>(L.RPL,", "if (rpl > R)"):
        assert line in _TILE, line
    store = _body("__device__ __forceinline__ void store_cells(")
    for line in ("for (int off = WARP / 2; off > 0; off /= 2)",
                 "if (off < L.LR || off >= L.LR * L.RS)",
                 "if (u == 0 && v == 0 && row < bm) out[b * col_stride"):
        assert line in store, line
    dense = _body("void tile_walk_general_dense_kernel(")
    assert "mb = (int)(item / L.groups), g = (int)(item % L.groups);" in dense
    launcher = _body("RT_API int rt_tile_walk_spmv(")
    for line in ("const int groups = fast   ? bm / 8",
                 ": mask ? MaskLayout(bm, bn).groups",
                 ": CellLayout(bm, bn).groups;",
                 "const long long items = (long long)Mb * groups;"):
        assert line in launcher, line
    # the fast walks keep their shapes; B == 1 takes one column a thread
    assert "const bool fast = bn == 128 && bm % 8 == 0;" in launcher
    assert "launch_tile_walk<1>(fast" in launcher


def _body(head):
    """The source from ``head`` to the end of its function."""
    text = _TILE[_TILE.index(head):]
    return text[:text.index("\n}\n")]


def _pow2(v):
    p = 1
    while p < v:
        p *= 2
    return p


def mask_layout(bm, bn):
    """MaskLayout: rows a warp RG, tile slots TPS, pieces a row P, warps a
    block row."""
    RG = min(bm & -bm, GENERAL_GROUP)
    return RG, WARP // RG, -(-bn // 128), bm // RG


def cell_layout(bm, bn):
    """CellLayout: cells a load V, loads a row CV, lanes a row LR, chunks
    a row NC, row slots RS, tile slots TPS, rows a lane RPL, rows a warp
    G, warps a block row."""
    V = 4 if bn % 4 == 0 else 1
    CV = bn // V
    LR = _pow2(min(CV, WARP))
    RS = min(WARP // LR, _pow2(bm), GENERAL_ROWS)
    RPL = min(_pow2(-(-bm // RS)), GENERAL_ROWS // RS)
    return dict(V=V, CV=CV, LR=LR, NC=-(-CV // LR), RS=RS,
                TPS=WARP // (LR * RS), RPL=RPL, G=RS * RPL,
                groups=-(-bm // (RS * RPL)))


def warp_items(items, groups):
    """The warps of a launch in order, ``WARPS_PER_BLOCK`` a block, those
    past ``items`` returning: each one's block row (or index) and group."""
    it = np.arange(-(-items // WARPS_PER_BLOCK) * WARPS_PER_BLOCK)
    it = it[it < items]
    return it // groups, it % groups


def _column_chunks(B):
    """grid.y: the columns each chunk of a launch takes (one thread keeps
    sums for 1 column at B = 1, ``RHS_CHUNK`` otherwise)."""
    nb = 1 if B == 1 else RHS_CHUNK
    return [range(b0, min(b0 + nb, B)) for b0 in range(0, B, nb)]


def masked_walk(t, data, X, n):
    """``tile_walk_general_kernel`` on the tiles ``t`` (mask, tile_cols,
    tile_ptr) for the (B, n) block X, every warp at once: lane (u, r) of
    warp (mb, g) walks row g*RG + r of items u, u + TPS, ... (item k: piece
    k % P of tile lo + k / P), reads the piece's mask bytes and, in
    ascending column, the marked cells below n (one float32 fma each), and
    the tile slots end in the butterfly over offsets RG, 2 RG, ..., 16.
    Returns y (B, Mb*bm), the stores of each output row, the reads of each
    cell and of each mask byte."""
    T, bm, bn = data.shape
    MB = bn // 8
    RG, TPS, P, groups = mask_layout(bm, bn)
    ptr = t.tile_ptr.astype(np.int64)
    Mb = len(ptr) - 1
    bits = np.unpackbits(t.mask, axis=2, count=bn).astype(bool)
    cols = t.tile_cols.astype(np.int64)
    stores = np.zeros(Mb * bm, np.int64)
    visits = np.zeros((T, bm, bn), np.int64)
    mask_reads = np.zeros((T, bm, MB), np.int64)
    y = np.full((X.shape[0], Mb * bm), np.nan, np.float32)
    mb, g = warp_items(Mb * groups, groups)
    lane = np.arange(WARP)
    r, u = lane % RG, lane // RG
    row = g[:, None] * RG + r[None]                         # (W, 32)
    lo, items = ptr[mb], (ptr[mb + 1] - ptr[mb]) * P
    for chunk in _column_chunks(X.shape[0]):
        Xc = X[list(chunk)]
        acc = np.zeros((len(mb), WARP, len(chunk)), np.float32)
        count = chunk.start == 0
        for s in range(-(-int(items.max(initial=0)) // TPS)):
            k = np.broadcast_to(u[None] + TPS * s, row.shape)
            live = k < items[:, None]
            ti = np.where(live, lo[:, None] + k // P, 0)
            p = k % P
            nbytes = np.minimum(16, MB - 16 * p)
            for q in range(16):
                on = live & (q < nbytes)
                if count:
                    np.add.at(mask_reads, (ti[on], row[on], (16 * p + q)[on]),
                              1)
            xc = cols[ti] * bn + 128 * p
            for jj in range(min(128, bn)):
                j = np.minimum(128 * p + jj, bn - 1)
                on = live & (128 * p + jj < bn) & bits[ti, row, j] \
                    & (xc + jj < n)
                xv = Xc[:, np.minimum(xc + jj, n - 1)].transpose(1, 2, 0)
                acc = np.where(on[..., None],
                               _fma(acc, data[ti, row, j][..., None], xv), acc)
                if count:
                    np.add.at(visits, (ti[on], row[on], j[on]), 1)
        off = RG
        while off < WARP:
            acc = (acc + acc[:, lane ^ off]).astype(np.float32)
            off *= 2
        out = (mb[:, None] * bm + row)[:, u == 0]
        for b, col in enumerate(chunk):
            y[col, out.reshape(-1)] = acc[:, u == 0, b].reshape(-1)
        if count:
            np.add.at(stores, out.reshape(-1), 1)
    return y, stores, visits, mask_reads


def cells_walk(data, lo, hi, g, xval, B, bm, bn):
    """The null-mask and ``tile_contrib`` walks (``cells_walk`` and
    ``store_cells``), one warp a row of ``lo``/``hi``/``g`` (its block
    row's tiles and its group): lane (u, r, v) walks items u, u + TPS, ...
    (item k: chunk k % NC of tile lo + k / NC), takes load w = (k % NC) *
    LR + v below CV, and adds its V cells, in column order, to each of its
    rows g*G + r + RS*i (i < RPL) below bm; each row ends in the butterfly
    over the offsets 16 .. 1 that are not row bits, stored by lane
    (0, r, 0).  ``xval(warp, t, c)`` is the x the cells c of tiles t meet,
    (W, 32, B).  Returns the rows' sums (W, RPL, 32 lanes, B) at the
    storing lanes' positions, the row of each (W, RPL, 32) and the reads of
    each cell."""
    L = cell_layout(bm, bn)
    V, LR, RS, TPS, NC = L["V"], L["LR"], L["RS"], L["TPS"], L["NC"]
    lane = np.arange(WARP)
    v, r, u = lane % LR, (lane // LR) % RS, lane // (LR * RS)
    W = len(lo)
    items = (hi - lo) * NC
    part = np.zeros((W, L["RPL"], WARP, B), np.float32)
    rows = g[:, None, None] * L["G"] + r[None, None] \
        + RS * np.arange(L["RPL"])[None, :, None]             # (W, RPL, 32)
    visits = np.zeros(data.shape, np.int64)
    warp = np.arange(W)[:, None]
    for s in range(-(-int(items.max(initial=0)) // TPS)):
        k = np.broadcast_to(u[None] + TPS * s, (W, WARP))
        w = (k % NC) * LR + v[None]
        ok = (k < items[:, None]) & (w < L["CV"])
        ti = np.where(ok, lo[:, None] + k // NC, 0)
        for j in range(V):
            c = np.where(ok, V * w + j, 0)
            xv = np.where(ok[..., None], xval(warp, ti, c), 0.0)
            for i in range(L["RPL"]):
                rv = ok & (rows[:, i] < bm)
                d = data[ti, np.minimum(rows[:, i], bm - 1), c]
                part[:, i] = np.where(rv[..., None],
                                      _fma(part[:, i], d[..., None], xv),
                                      part[:, i])
                np.add.at(visits, (ti[rv], rows[:, i][rv], c[rv]), 1)
    off = WARP // 2
    while off:
        if off < LR or off >= LR * RS:
            part = (part + part[:, :, lane ^ off]).astype(np.float32)
        off //= 2
    keep = (u == 0) & (v == 0)
    return part[:, :, keep], rows[:, :, keep], visits


def dense_walk(t, data, X, n):
    """``tile_walk_general_dense_kernel`` over every warp: (y, stores,
    visits) as :func:`masked_walk`."""
    T, bm, bn = data.shape
    L = cell_layout(bm, bn)
    ptr = t.tile_ptr.astype(np.int64)
    Mb = len(ptr) - 1
    cols = t.tile_cols.astype(np.int64)
    y = np.full((X.shape[0], Mb * bm), np.nan, np.float32)
    stores = np.zeros(Mb * bm, np.int64)
    mb, g = warp_items(Mb * L["groups"], L["groups"])
    visits = None
    for chunk in _column_chunks(X.shape[0]):
        Xc = X[list(chunk)]

        def xval(warp, ti, c):
            pos = cols[ti] * bn + c
            return np.where((pos < n)[..., None],
                            Xc[:, np.minimum(pos, n - 1)].transpose(1, 2, 0),
                            0.0)
        part, rows, seen = cells_walk(data, ptr[mb], ptr[mb + 1], g, xval,
                                      len(chunk), bm, bn)
        live = rows < bm
        out = (mb[:, None, None] * bm + rows)[live]
        for b, col in enumerate(chunk):
            y[col, out] = part[..., b][live]
        if visits is None:
            visits = seen
            np.add.at(stores, out, 1)
    return y, stores, visits


def _walk_case(bm, bn):
    """The tiles of powerlaw(1000, 8000, seed=5) with every 7th entry a
    stored zero and rows 200-329 emptied (block rows without tiles); n =
    1000 ends inside a block of 64 or 256 columns.  ``tile_from_csr``
    where bn % 8 == 0, else the (bm, bn) blocks of ``csr_to_bcsr`` as the
    tiles (the null-mask walk's Block-ELL slab, any bn)."""
    A = powerlaw(1000, 8000, seed=5)
    rows = np.repeat(np.arange(1000), np.diff(A.row_ptr))
    vals = A.values.copy()
    vals[::7] = 0.0
    keep = (rows < 200) | (rows >= 330)
    A = csr_from_coo(rows[keep], A.col_index[keep], vals[keep], A.shape)
    if bn % 8 == 0:
        return r_ops.tile_from_csr(A, bm=bm, bn=bn), A.shape[1]
    b = csr_to_bcsr(A, (bm, bn))
    ptr = np.asarray(b.block_row_ptr, np.int32)
    return types.SimpleNamespace(
        data=b.blocks, tile_cols=np.asarray(b.block_cols, np.int32),
        tile_ptr=ptr, num_tiles=len(b.blocks), bm=bm, bn=bn,
        tile_rows=np.repeat(np.arange(len(ptr) - 1), np.diff(ptr)).astype(
            np.int32)), A.shape[1]


def _walk64(t, X, n):
    """The tile walk in float64 on the (B, n) block X and on |data|, |X|
    (x 0 past n): the sums and their scale, (B, Mb*bm)."""
    T, bm, bn = t.data.shape
    Mb = len(t.tile_ptr) - 1
    xp = np.zeros((X.shape[0], -(-n // bn) * bn + bn))
    xp[:, :n] = X
    lanes = t.tile_cols.astype(np.int64)[:, None] * bn + np.arange(bn)
    brow = np.repeat(np.arange(Mb), np.diff(t.tile_ptr))
    out = []
    for d, x in ((t.data, xp), (np.abs(t.data), np.abs(xp))):
        y = np.zeros((X.shape[0], Mb, bm))
        np.add.at(y, (slice(None), brow),
                  np.einsum("tij,btj->bti", d.astype(np.float64), x[:, lanes]))
        out.append(y.reshape(X.shape[0], Mb * bm))
    return out


def _held(y, X, t, n, single):
    """Column 0 within 1e-5 (on |A|·|x|) of the Pallas ``tile_walk_spmv``
    in interpret mode, every column within 1e-5 of the walk in float64;
    columns 0, B/2 and B-1 bitwise the single-vector call ``single(x)``."""
    B, bn = X.shape[0], t.data.shape[2]
    want, scale = _walk64(t, X, n)
    _within(y, want, scale, SCHEDULE_TOL)
    xp = np.zeros(-(-n // bn) * bn, np.float32)
    xp[:n] = X[0]
    c, tid, bc = r_ops._tile_walk_tables(t)
    _within(y[0], r_tile_walk_pallas(t.data, c, tid, bc, jnp.asarray(xp),
                                     interpret=True), scale[0], SCHEDULE_TOL)
    for b in {0, B // 2, B - 1}:
        np.testing.assert_array_equal(single(X[b:b + 1])[0], y[b])


COLUMNS = 11                    # two column chunks of RHS_CHUNK


@pytest.mark.parametrize("bn", [8, 16, 40, 64, 256])
@pytest.mark.parametrize("bm", [4, 5, 12, 16])
def test_general_walk_schedule(bm, bn):
    # the masked walk: every marked cell below n read once and no other
    # (unmarked cells hold NaN), every mask byte read once, every output
    # row stored once, the sums within 1e-5 of the Pallas walk, batched
    # columns bitwise the single-vector call
    t, n = _walk_case(bm, bn)
    assert (np.diff(t.tile_ptr) == 0).any()
    bits = t.occupancy()
    assert (t.data[bits] == 0).any()                    # a stored zero
    data = np.where(bits, t.data, np.nan).astype(np.float32)
    X = np.random.default_rng(7).standard_normal((COLUMNS, n)) \
        .astype(np.float32)
    y, stores, visits, mask_reads = masked_walk(t, data, X, n)
    assert (stores == 1).all() and (mask_reads == 1).all()
    cols = t.tile_cols.astype(np.int64)
    in_x = (cols[:, None] * bn + np.arange(bn))[:, None, :] < n
    np.testing.assert_array_equal(visits, (bits & in_x).astype(np.int64))
    RG, TPS, _, _ = mask_layout(bm, bn)
    assert RG * TPS == WARP and bm % RG == 0        # full groups, no idle lane
    _held(y, X, t, n, lambda v: masked_walk(t, data, v, n)[0])


@pytest.mark.parametrize("bm,bn", [(4, 8), (16, 16), (12, 16), (5, 40),
                                   (12, 40), (16, 64), (4, 256), (16, 6),
                                   (5, 10), (3, 1)])
def test_general_dense_walk_schedule(bm, bn):
    # the null-mask walk: every cell read once, every output row stored
    # once, the sums within 1e-5 of the Pallas walk (x 0 past n), batched
    # columns bitwise the single-vector call; where bn and bm are powers
    # of two every lane holds a load
    t, n = _walk_case(bm, bn)
    X = np.random.default_rng(8).standard_normal((COLUMNS, n)) \
        .astype(np.float32)
    data = np.ascontiguousarray(t.data, np.float32)
    y, stores, visits = dense_walk(t, data, X, n)
    assert (stores == 1).all() and (visits == 1).all()
    L = cell_layout(bm, bn)
    if _pow2(bm) == bm and _pow2(bn) == bn:
        assert L["CV"] % L["LR"] == 0 and bm % L["G"] == 0
    _held(y, X, t, n, lambda v: dense_walk(t, data, v, n)[0])


# --------------------------------------------------------------------------
# tile_contrib's general launch
# --------------------------------------------------------------------------

def test_general_contrib_launch_matches_the_source():
    body = _body("int launch_contrib_general(")
    for line in ("const CellLayout L(bm, bn);",
                 "(long long)n_sids * rb_used * L.groups;",
                 "(items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;",
                 "nb = B < RHS_CHUNK ? B : RHS_CHUNK;",
                 "(long long)n_sids * nb * (Rb - rb_used) * bm;",
                 "(long long)WARPS_PER_BLOCK * WARP * FILL_STORES;",
                 "(fill + per_block - 1) / per_block;"):
        assert line in body, line
    kernel = _body("__global__ void tile_contrib_general_kernel(")
    for line in ("const long long per_shard = (long long)rb_used * L.groups;",
                 "const int k = (int)(item / per_shard);",
                 "mb = (int)(rem / L.groups), g = (int)(rem % L.groups);",
                 "cells_walk<NB, V, R>(c, L, ptr[mb], ptr[mb + 1], g, bm,"):
        assert line in kernel, line
    launcher = _TILE[_TILE.index("RT_API int rt_tile_spmv("):]
    assert "if (BM != 8 || BN != 128)\n    return launch_contrib_general(" \
        in launcher


def contrib_launch(n_sids, Rb, rb_used, B, bm, bn):
    """``launch_contrib_general``'s grid, per column chunk: the warps'
    items (k, mb, g) and the fill stores' (k, b, row), in launch order."""
    groups = cell_layout(bm, bn)["groups"]
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
            warps.append((k,) + divmod(rem, groups))
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


@pytest.mark.parametrize("n_sids,Rb,rb_used,B,bm,bn", [
    (3, 40, 34, 11, 5, 40),      # odd bm: rows from rb_used * 5 on
    (2, 17, 17, 3, 12, 16),      # rb_used = Rb: no fill
    (2, 50, 0, 9, 4, 8),         # no tiles: fill only
    (3, 300, 26, 1, 16, 128),
])
def test_general_contrib_launch_covers_once(n_sids, Rb, rb_used, B, bm, bn):
    R = Rb * bm
    L = cell_layout(bm, bn)
    rows = np.zeros((n_sids, B, R), np.int64)
    lane = np.arange(WARP)
    r = (lane // L["LR"]) % L["RS"]
    keep = (lane % L["LR"] == 0) & (lane // (L["LR"] * L["RS"]) == 0)
    for b0, nb, warps, stores in contrib_launch(n_sids, Rb, rb_used, B, bm,
                                                bn):
        for k, mb, g in warps:                          # store_cells' rows
            assert mb < rb_used and g < L["groups"]
            for i in range(L["RPL"]):
                row = g * L["G"] + r[keep] + L["RS"] * i
                row = row[row < bm]
                rows[k, b0:b0 + nb, mb * bm + row[:, None]] += 1
        for k, b, row in stores:
            assert row >= rb_used * bm
            rows[k, b, row] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("bm,bn", [(4, 8), (4, 64), (16, 16), (16, 64),
                                   (16, 128), (16, 256), (5, 40), (12, 16),
                                   (12, 40), (5, 10)])
def test_general_contrib_schedule(bm, bn):
    # flat_tile_case's shards: padding tiles hold NaN (never read), shard 1
    # has no tiles, rb_used < Rb, shard 3 is not listed; every real cell
    # read once, every output row written once (by a warp or the fill),
    # the sums within 1e-5 of the Pallas tile_contrib plus its scatter,
    # batched columns bitwise the single-vector call
    t, n = _walk_case(bm, bn)
    data, xcol, brow, ptr, x, sids, rb_used, Rb = (
        v.numpy() if isinstance(v, torch.Tensor) else v
        for v in flat_tile_case(t, n, COLUMNS))
    x = np.ascontiguousarray(x.transpose(0, 2, 1))  # (S, B, n): a column a row
    ptr = ptr.astype(np.int64)
    Tp = data.shape[1]

    def contrib(xs):
        B = xs.shape[1]
        y = np.full((4, B, Rb * bm), np.nan, np.float32)
        writes = np.zeros((4, B, Rb * bm), np.int64)
        visits = np.zeros(data.shape, np.int64)
        for b0, nb, warps, stores in contrib_launch(len(sids), Rb, rb_used,
                                                    B, bm, bn):
            k, mb, g = (np.array([w[i] for w in warps], np.int64)
                        for i in range(3))
            s = sids[k]
            Xc = xs[:, b0:b0 + nb]

            def xval(warp, ti, c, s=s, Xc=Xc):
                sx = np.broadcast_to(s[warp], ti.shape) if len(Xc) > 1 else 0
                return Xc[sx, :, xcol.reshape(-1, bn)[ti, c]]
            part, rows, seen = cells_walk(
                data.reshape(-1, bm, bn), s * Tp + ptr[s, mb],
                s * Tp + ptr[s, mb + 1], g, xval, nb, bm, bn)
            live = rows < bm
            pos = (mb[:, None, None] * bm + rows)[live]
            sh = np.broadcast_to(s[:, None, None], rows.shape)[live]
            for b in range(nb):
                y[sh, b0 + b, pos] = part[..., b][live]
                np.add.at(writes, (sh, b0 + b, pos), 1)
            if b0 == 0:
                visits += seen.reshape(data.shape)
            for kk, b, row in stores:
                y[sids[kk], b, row] = 0.0
                writes[sids[kk], b, row] += 1
        return y, writes, visits

    y, writes, visits = contrib(x)
    assert np.isnan(y[3]).all() and not writes[3].any()
    assert (writes[sids] == 1).all()
    assert not visits[3].any()
    X = x[0] if x.shape[0] == 1 else None
    for s in sids:
        real = brow[s] < Rb
        assert (visits[s][real] == 1).all() and not visits[s][~real].any()
        assert not y[s, :, rb_used * bm:].any()
        if not real.any():                  # shard 1: zeros, from the fill
            assert not y[s].any()
            continue
        xs = x[s] if X is None else X
        d = data[s][real].astype(np.float64)
        for v, ref in ((d, xs), (np.abs(d), np.abs(xs))):
            contrib_ = np.einsum("tij,btj->bti", v, ref[:, xcol[s][real]])
            acc = np.zeros((COLUMNS, Rb, bm))
            np.add.at(acc, (slice(None), brow[s][real]), contrib_)
            if v is d:
                want = acc.reshape(COLUMNS, Rb * bm)
            else:
                scale = acc.reshape(COLUMNS, Rb * bm)
        _within(y[s], want, scale, SCHEDULE_TOL)
        _within(y[s, 0], r_ops.tile_flat_spmv(
            data[s][real], xcol[s][real], brow[s][real], jnp.asarray(xs[0]),
            num_rows=Rb * bm, use_kernel=True, interpret=True), scale[0],
            SCHEDULE_TOL)
    for b in {0, COLUMNS // 2, COLUMNS - 1}:
        one = contrib(np.ascontiguousarray(x[:, b:b + 1]))[0]
        np.testing.assert_array_equal(one[sids, 0], y[sids, b])
