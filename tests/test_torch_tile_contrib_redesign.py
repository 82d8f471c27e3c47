"""The work split and order of adds of the redesigned ``tile_contrib``.

The CUDA kernel cannot run here, so its launch (the grid ``rt_tile_spmv``
computes, mirrored by :func:`contrib_grid` from the source's constants)
and its arithmetic are emulated in numpy, warp by warp and lane by lane
(float32, one rounding a fused multiply-add), and held to the reference:

* warps only where tiles are: a tile block's warps walk (shard, block
  row) items with block row < ``rb_used``, one each, and no warp is spent
  on a block row at or past it (blocked_band's tile shards: 78 blocks of
  8 warps, not 2,799);
* the zero fill past it: the fill blocks' 16-byte stores cover rows
  ``rb_used * 8`` .. R of every listed shard and column exactly once;
* lanes across the tile row: lane l adds cells 4l .. 4l+3 of each of the
  8 rows in column order into its running partial, across the block
  row's tiles in tile order, and the 32 lanes are summed once at the end
  with ``warp_sum``'s butterfly (offsets 16, 8, 4, 2, 1);
* ``RHS_CHUNK`` columns a chunk of ``grid.y``; each column's adds are the
  single-vector call's, so columns of B = 3, 8, 11 equal it bitwise.

The emulation is held within 1e-5 (on |A|·|x|) of the reference's Pallas
``tile_contrib`` in interpret mode plus its block-row scatter (the
reference's ``tile_flat_spmv`` kernel path), on ``contrib_case``'s
operands (padding tiles holding NaN, a shard with no tiles, empty block
rows below ``rb_used``, a block row of 64 tiles, an unlisted shard) and on
the executor's own.  ``rb_used`` from ``make_program_spmv_fn`` is checked
against the block rows ``tile_ptr`` and ``tile_brow`` give.
"""
import re

import numpy as np
import pytest
import torch

import repro.data.matrices as r_mat
import repro.kernels.ops as r_ops

import repro_torch.core.program as t_program
from repro_torch.core.spmv import SpmvPlan as TPlan
from repro_torch.kernels import _lib, spmv_tile

from test_torch_cuda import PLANS, contrib_case
from test_torch_redesign import _fma, _port, _within

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

KERNEL_TOL = 1e-5
WARP = 32
_SRC = (_lib.CSRC / "spmv_tile.cu").read_text()
_COMMON = (_lib.CSRC / "common.cuh").read_text()


def _const(name, src=_SRC):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


WARPS_PER_BLOCK = _const("WARPS_PER_BLOCK")
FILL_STORES = _const("FILL_STORES")
RHS_CHUNK = _const("RHS_CHUNK", _COMMON)


def test_launch_constants_match_the_source():
    # the grid the C launcher computes, from the constants mirrored here
    body = _SRC[_SRC.index("RT_API int rt_tile_spmv("):]
    for line in ("(items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;",
                 "nb = B < RHS_CHUNK ? B : RHS_CHUNK;",
                 "(long long)n_sids * nb * (Rb - rb_used) * BM / 4;",
                 "(long long)WARPS_PER_BLOCK * WARP * FILL_STORES;",
                 "(fill + per_block - 1) / per_block;"):
        assert line in body, line


def contrib_grid(n_sids, Rb, rb_used, B, bm=8):
    """``rt_tile_spmv``'s grid along x: (tile blocks, fill blocks).

    Tile block i holds the warps ``WARPS_PER_BLOCK * i + w``, warp item
    ``(k, mb) = divmod(item, rb_used)`` walking block row mb < rb_used of
    shard ``sids[k]``; the fill blocks that follow store zeros over rows
    ``rb_used * bm`` .. ``Rb * bm`` of every listed shard and column, in
    16-byte stores, ``FILL_STORES`` a thread.  Each ``grid.y`` takes
    ``RHS_CHUNK`` columns."""
    tile_blocks = -(-n_sids * rb_used // WARPS_PER_BLOCK)
    fill = n_sids * min(B, RHS_CHUNK) * (Rb - rb_used) * bm // 4
    fill_blocks = -(-fill // (WARPS_PER_BLOCK * WARP * FILL_STORES))
    return tile_blocks, fill_blocks


def launch(n_sids, Rb, rb_used, B):
    """The warp items and fill stores of one launch, per column chunk:
    ``[(b0, nb, items, stores)]``, items the (k, mb) each tile warp walks
    and stores the flat float4 index of each fill store, in thread order
    (the kernel's grid-stride loop)."""
    tile_blocks, fill_blocks = contrib_grid(n_sids, Rb, rb_used, B)
    threads = WARPS_PER_BLOCK * WARP
    out = []
    for cy in range(-(-B // RHS_CHUNK)):      # grid.y
        b0 = cy * RHS_CHUNK
        nb = min(RHS_CHUNK, B - b0)
        items = [divmod(it, rb_used)
                 for it in range(tile_blocks * WARPS_PER_BLOCK)
                 if it < n_sids * rb_used]
        total = n_sids * nb * (Rb - rb_used) * 2
        step = fill_blocks * threads
        # thread g stores g, g + step, ... below total
        g = np.arange(step)
        q = (g[None] + step * np.arange(-(-total // max(step, 1)))[:, None])
        stores = q.T[q.T < total]
        out.append((b0, nb, items, stores))
    return out


@pytest.mark.parametrize("n_sids,Rb,rb_used,B", [
    (3, 7463, 208, 1),          # blocked_band's tile shards, one pass
    (3, 7463, 208, 8),
    (3, 40, 34, 11),
    (2, 50, 0, 3),              # no tiles: fill blocks only
    (5, 17, 17, 2),             # rb_used = Rb: tile blocks only
])
def test_warps_only_below_rb_used(n_sids, Rb, rb_used, B):
    tile_blocks, fill_blocks = contrib_grid(n_sids, Rb, rb_used, B)
    per_block = WARPS_PER_BLOCK
    assert tile_blocks == -(-n_sids * rb_used // per_block)
    assert (fill_blocks == 0) == (rb_used == Rb)
    if (n_sids, Rb, rb_used, B) == (3, 7463, 208, 1):
        # one wave on the H100's 132 SMs, where one warp per block row
        # took 2,799 blocks
        assert tile_blocks == 78 and tile_blocks + fill_blocks <= 132
    threads = per_block * WARP
    for b0, nb, items, stores in launch(n_sids, Rb, rb_used, B):
        assert sorted(items) == [(k, mb) for k in range(n_sids)
                                 for mb in range(rb_used)]
        total = n_sids * nb * (Rb - rb_used) * 2
        assert np.array_equal(np.sort(stores), np.arange(total))
        # FILL_STORES 16-byte stores a thread, at most
        assert total <= fill_blocks * threads * FILL_STORES


def emulate_contrib(data, xcol, tile_ptr, x, sids, rb_used, out):
    """The kernel's launch over ``out`` (numpy, written in place): returns
    the (k, mb) items walked and, per output entry, how often it was
    written.  ``x`` is batch-minor, (1 or S, Lx, B)."""
    S, Tp, bm, bn = data.shape
    B, Rb = x.shape[2], tile_ptr.shape[1] - 1
    R = Rb * bm
    writes = np.zeros(out.shape, int)
    walked = []
    lanes = np.arange(WARP)
    for b0, nb, items, stores in launch(len(sids), Rb, rb_used, B):
        for k, mb in items:
            sid = int(sids[k])
            walked.append((k, mb))
            xs = x[sid if x.shape[0] > 1 else 0, :, b0:b0 + nb]  # (Lx, nb)
            lo, hi = int(tile_ptr[sid, mb]), int(tile_ptr[sid, mb + 1])
            # lane l: cells 4l .. 4l+3 of each row, partials (8, 32, nb)
            part = np.zeros((bm, WARP, nb), np.float32)
            for t in range(lo, hi):
                d = data[sid, t].reshape(bm, WARP, 4)
                xg = xs[xcol[sid, t]].reshape(WARP, 4, nb)  # a cell's row
                for j in range(4):
                    part = _fma(part, d[:, :, j, None], xg[:, j][None])
            for off in (16, 8, 4, 2, 1):                 # warp_sum's order
                part = np.float32(part + part[:, lanes ^ off])
            rows = slice(mb * bm, (mb + 1) * bm)
            out[sid, b0:b0 + nb, rows] = part[:, 0].T
            writes[sid, b0:b0 + nb, rows] += 1
        per = (R - rb_used * bm) // 4
        kb, q = np.divmod(stores, per)
        k, b = np.divmod(kb, nb)
        for c in range(4):
            idx = (np.asarray(sids)[k], b0 + b, rb_used * bm + 4 * q + c)
            out[idx] = 0.0
            np.add.at(writes, idx, 1)
    return walked, writes


def reference(data, xcol, brow, x, sids, R):
    """The reference's Pallas ``tile_contrib`` (interpret mode) and its
    block-row scatter, per listed shard, all columns: (n, B, R)."""
    y = []
    for sid in sids:
        xv = x[sid if x.shape[0] > 1 else 0]                    # (Lx, B)
        y.append(np.asarray(r_ops.tile_flat_spmv(
            data[sid], xcol[sid], brow[sid], xv, num_rows=R,
            use_kernel=True, interpret=True)).T)
    return np.stack(y)


@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8, 11])
def test_emulation_matches_reference(B, shared_x):
    data, xcol, brow, tile_ptr, x, sids, rb_used, Rb = (
        a.numpy() if torch.is_tensor(a) else a
        for a in contrib_case(B, shared_x=shared_x))
    assert t_program._tile_rows_used(tile_ptr, sids) == rb_used
    S, R = data.shape[0], Rb * 8
    out = np.full((S, B, R), np.nan, np.float32)
    walked, writes = emulate_contrib(data, xcol, tile_ptr, x, sids, rb_used,
                                     out)
    n = len(sids)
    assert sorted(set(walked)) == [(k, mb) for k in range(n)
                                   for mb in range(rb_used)]
    # every entry of a listed shard written exactly once; shard 3 untouched
    assert (writes[sids] == 1).all() and not writes[3].any()
    assert np.isnan(out[3]).all()
    assert not out[sids][:, :, rb_used * 8:].any()
    got = out[sids]
    want = reference(data, xcol, brow, x, sids, R)
    absd = np.where(np.isnan(data), np.nan, np.abs(data))
    scale = reference(absd, xcol, brow, np.abs(x), sids, R)
    _within(got, want, scale, KERNEL_TOL)
    # the block row of 64 tiles and the shard without tiles
    assert np.diff(tile_ptr[0]).max() == 64 and tile_ptr[1, -1] == 0
    # the wrapper's CPU path (the plain version) agrees
    plain = spmv_tile.tile_contrib(
        *(torch.from_numpy(a) for a in (data, xcol, brow, tile_ptr, x)),
        torch.from_numpy(sids), rb_used=rb_used).numpy()[sids]
    _within(got, plain, scale, KERNEL_TOL)
    # each column is the single-vector call's arithmetic, bitwise
    for b in range(B):
        one = np.full((S, 1, R), np.nan, np.float32)
        emulate_contrib(data, xcol, tile_ptr, x[..., b:b + 1], sids, rb_used,
                        one)
        assert np.array_equal(one[sids][:, 0], got[:, b])


def test_plain_drops_tiles_past_rb_used():
    data, xcol, brow, tile_ptr, x, sids, rb_used, Rb = contrib_case(3)
    full = spmv_tile.tile_contrib(data, xcol, brow, tile_ptr, x, sids)
    cut = spmv_tile.tile_contrib(data, xcol, brow, tile_ptr, x, sids,
                                 rb_used=10)
    rows = sids.long()
    assert torch.equal(cut[rows, :, :80], full[rows, :, :80])
    assert not cut[rows, :, 80:].any() and full[rows, :, 80:].any()
    assert torch.equal(spmv_tile.tile_contrib(
        data, xcol, brow, tile_ptr, x, sids, rb_used=rb_used)[rows],
        full[rows])
    for bad in (-1, Rb + 1):
        with pytest.raises(ValueError, match="rb_used"):
            spmv_tile.tile_contrib(data, xcol, brow, tile_ptr, x, sids,
                                   rb_used=bad)


def _program(plan):
    # the card tests' mixed matrix: its tile shards reach 5 and 7 of 232
    # block rows in the two passes
    A = r_mat.blocked_band(4096, 4096 * 24, seed=0)
    tp = t_program.lower(_port(A), TPlan(**plan))
    return A, tp, t_program.make_program_spmv_fn(tp, device="cpu")


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_rb_used_matches_tile_ptr(plan):
    _, tp, run = _program(PLANS[plan])
    ops = t_program._device_operands(tp)
    tile = np.flatnonzero(ops["kid"] == t_program.PROGRAM_KERNELS.index(
        "tile"))
    Rb = ops["R"] // 8
    for pre in ("loc_", "rem_"):
        brow = ops[pre + "tile_brow"][tile]
        real = brow[brow < Rb]
        assert run.rb_used[pre] == (int(real.max()) + 1 if real.size else 0)
        ptr = ops[pre + "tile_ptr"][tile]
        # no tile of the family at or past rb_used, one in the row below
        assert (ptr[:, run.rb_used[pre]] == ptr[:, -1]).all()
        if run.rb_used[pre]:
            assert (ptr[:, run.rb_used[pre]]
                    > ptr[:, run.rb_used[pre] - 1]).any()
    if plan == "mixed":
        assert 0 < min(run.rb_used.values()) <= max(run.rb_used.values()) < Rb


def test_emulation_on_executor_operands():
    # both passes of the mixed program's tile family: warps only where
    # the family's tiles are, against the reference
    A, tp, run = _program(PLANS["mixed"])
    T, sids = run.operands, run.families["tile"].numpy()
    x = np.random.default_rng(0).standard_normal((A.ncols, 3)) \
        .astype(np.float32)
    R = run.rows_out
    for pre, xbuf in zip(("loc_", "rem_"), run.buffers(tp.x_to_device(x))):
        data, xcol, brow, ptr = (T[pre + k].numpy() for k in (
            "tile_data", "tile_xcol", "tile_brow", "tile_ptr"))
        xb = xbuf.numpy()
        rb_used = run.rb_used[pre]
        out = np.full((data.shape[0], 3, R), np.nan, np.float32)
        walked, _ = emulate_contrib(data, xcol, ptr, xb, sids, rb_used, out)
        assert len(walked) == len(sids) * rb_used < len(sids) * (R // 8)
        want = reference(data, xcol, brow, xb, sids, R)
        scale = reference(np.abs(data), xcol, brow, np.abs(xb), sids, R)
        _within(out[sids], want, scale, KERNEL_TOL)
