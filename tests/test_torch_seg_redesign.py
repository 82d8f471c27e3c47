"""The schedules of the redesigned ``seg_fixup`` and ``seg_psum`` kernels.

The CUDA kernels cannot run here, so their work split and their order of
arithmetic are emulated in numpy (float32, one rounding an operation, as
the kernels' ``__fadd_rn`` / ``__fmul_rn``) and held to the reference:

* (a) the fix-up: a warp owns 32 consecutive rows of a shard; a lane
  walks its row alone when it has at most ``LONG_ROW`` pieces (running
  sums restarted at each change of split, then all NS outputs); then a
  block's longer rows are dealt out to its ``FIXUP_WARPS`` warps in turn,
  and a warp loads its row in rounds of ``LONG_LOADS`` * 32 pieces, each
  round staged, added in piece order and its ended runs stored.  The
  emulation takes each long row exactly once, by the warp the kernel
  deals it to, counts every real piece exactly once, never adds a padded
  piece row ``[0, 1, 0, 0, 0]`` or a piece past the real count, equals
  ``seg_fixup_plain`` bitwise, and equals the reference jnp fix-ups
  ``_seg_fixup`` / ``_split_flat_fixup`` within 1e-5 of the sum of the
  |differences| (the scatter-add adds in another order);
* (b) the scan: one warp per chunk, steps of 128 elements, 4 serial
  products a lane, a shuffle scan over the lane totals and the step's
  carry from lane 31; within 1e-5 (on |A|·|x|) of the reference Pallas
  ``seg_psum`` in interpret mode, at every chunk length L the wrapper
  accepts from 32 to 1024.

Inputs are made with numpy from a seed.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.matrices as r_mat
import repro.kernels.ops as r_ops
from repro.kernels.spmv_seg import seg_psum as r_seg_psum_pallas

import repro_torch.core.program as t_program
from repro_torch.core.spmv import SpmvPlan as TPlan
from repro_torch.kernels import _lib
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import spmv_seg

from test_torch_cuda import fixup_case
from test_torch_redesign import _port

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-5
WARP = 32
_SRC = (_lib.CSRC / "spmv_seg.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


LONG_ROW, LONG_LOADS, FIXUP_WARPS = (_const(c) for c in (
    "LONG_ROW", "LONG_LOADS", "FIXUP_WARPS"))
ROUND = LONG_LOADS * WARP
STEP = 4 * WARP


# --------------------------------------------------------------------------
# (a) the carry fix-up
# --------------------------------------------------------------------------

def emulate_fixup(psum, pieces, piece_ptr, sids, out_ids, ns, out):
    """The kernel's work split and sums, every column at once; returns
    ``out``, per launched shard how often each piece slot was read
    (``seen``) and added (``added``), and which (block, warp) took each
    long row (k, r)."""
    psum, pcs, ptr = psum.numpy(), pieces.numpy(), piece_ptr.numpy()
    out = out.numpy()
    B, R = psum.shape[1], ptr.shape[1] - 1
    wps = -(-R // WARP)                             # warps a shard
    zero = np.zeros(B, np.float32)
    seen = np.zeros((len(sids), pcs.shape[1]), int)
    added = np.zeros_like(seen)
    taken = {}

    def piece(k, q):
        """Split and prefix difference of piece q (0 for lo > hi)."""
        seen[k, q] += 1
        chunk, lo, hi, _, split = pcs[sids[k], q]
        split = split if ns > 1 else 0
        if lo > hi:
            return split, zero
        added[k, q] += 1
        h = psum[k, :, chunk, hi]
        return split, h - psum[k, :, chunk, lo - 1] if lo > 0 else h

    def y(k):
        return out[out_ids[k]].reshape(B, ns, R)

    n_warps = len(sids) * wps
    for blk in range(-(-n_warps // FIXUP_WARPS)):
        rows = [(w // wps, (w % wps) * WARP + lane)     # (k, r) of each lane
                for w in range(blk * FIXUP_WARPS,
                               min(blk * FIXUP_WARPS + FIXUP_WARPS, n_warps))
                for lane in range(WARP) if (w % wps) * WARP + lane < R]
        spans = {(k, r): (int(ptr[sids[k], r]), int(ptr[sids[k], r + 1]))
                 for k, r in rows}
        longs = [(k, r) for k, r in rows
                 if spans[k, r][1] - spans[k, r][0] > LONG_ROW]
        for k, r in rows:                           # short rows first
            p, pe = spans[k, r]
            m = 0 if pe - p > LONG_ROW else pe - p  # a long row's lane: 0s
            run, acc = [], zero
            for j in range(m):
                split, d = piece(k, p + j)
                if j and split != run[-1][0]:
                    acc = zero
                acc = acc + d
                run.append((split, acc))
            if ns == 1:
                if m == pe - p:                     # a long row's: below
                    y(k)[:, 0, r] = acc
                continue
            for t in range(ns):                     # every split of the row
                v = zero
                for split, s in run:                # the run's last sum wins
                    if split == t:
                        v = s
                y(k)[:, t, r] = v
        for rank, (k, r) in enumerate(longs):       # then the long rows
            taken[k, r] = (blk, rank % FIXUP_WARPS)
            p, pe = spans[k, r]
            acc, t = zero, -1
            for base in range(p, pe, ROUND):
                loaded = [piece(k, q) for q in range(base, min(base + ROUND,
                                                               pe))]
                sums = []
                for split, d in loaded:             # lane b's fold, in order
                    acc = (acc if split == t else zero) + d
                    t = split
                    sums.append(acc)
                nxt = (int(pcs[sids[k], base + ROUND, 4]) if ns > 1 else 0) \
                    if base + ROUND < pe else -1
                for i, (split, _) in enumerate(loaded):    # the ended runs
                    after = loaded[i + 1][0] if i + 1 < len(loaded) else nxt
                    if after != split:
                        y(k)[:, split, r] = sums[i]
    return torch.from_numpy(out), seen, added, taken


def _check_visits(seen, added, taken, pieces, piece_ptr, sids):
    """Every piece inside its row range read once, added once unless it is
    padded (lo > hi); nothing past the shard's real count read; each long
    row taken once, and a block's long rows spread over its warps."""
    R = piece_ptr.shape[1] - 1
    lengths = (piece_ptr[:, 1:] - piece_ptr[:, :-1]).numpy()
    longs = {(k, r) for k, sid in enumerate(sids.tolist())
             for r in np.flatnonzero(lengths[sid] > LONG_ROW).tolist()}
    assert set(taken) == longs
    per_warp = {}
    for blk_warp in taken.values():
        per_warp[blk_warp] = per_warp.get(blk_warp, 0) + 1
    for (blk, _), count in per_warp.items():
        in_block = sum(1 for b, _ in taken.values() if b == blk)
        assert count == -(-in_block // FIXUP_WARPS) or \
            count == in_block // FIXUP_WARPS
    for k, sid in enumerate(sids.tolist()):
        n = int(piece_ptr[sid, R])
        live = (pieces[sid, :n, 1] <= pieces[sid, :n, 2]).numpy()
        assert (seen[k, :n] == 1).all() and not seen[k, n:].any()
        np.testing.assert_array_equal(added[k, :n], live.astype(int))
        assert not added[k, n:].any()


def _fixup_both(psum, pcs, ptr, sids, ids, ns, shape):
    """The emulation (with its visit check) and the plain version, both
    into NaN-filled outputs; returns the written rows of each."""
    o = ids.long()
    got, seen, added, taken = emulate_fixup(psum, pcs, ptr, sids, ids, ns,
                                            torch.full(shape, float("nan")))
    _check_visits(seen, added, taken, pcs, ptr, sids)
    want = spmv_seg.seg_fixup_plain(psum, pcs, ptr, sids, ids,
                                    torch.full(shape, float("nan")))
    return got[o], want[o]


@pytest.mark.parametrize("ns", [1, 8, 64])
def test_fixup_schedule_on_every_kind_of_row(ns):
    # rows without pieces, around the long-row threshold, whole and cut
    # batches of 32, 1,037 pieces in one split, padded piece rows
    psum, pcs, ptr, sids, ids, shape = fixup_case(ns, 3)
    lengths = (ptr[:, 1:] - ptr[:, :-1]).flatten()
    for size in (0, LONG_ROW, LONG_ROW + 1, 1037):
        assert (lengths == size).any()
    got, want = _fixup_both(psum, pcs, ptr, sids, ids, ns, shape)
    assert torch.equal(got, want)


def _ref_fixup(psum, chunk, lo, hi, row, split, ns, num_rows):
    """The reference jnp fix-up on one column's flat psum (C, L), and the
    sum of |differences| per (split, row), its error scale."""
    ps = jnp.asarray(psum)
    if ns == 1:
        want = np.asarray(r_ops._seg_fixup(ps, chunk, lo, hi, row,
                                           num_rows=num_rows))[None]
    else:
        table = np.stack([chunk, lo, hi, row, split], 1)
        want = np.asarray(r_ops._split_flat_fixup(ps, table, num_splits=ns,
                                                  num_rows=num_rows))
    h = psum[chunk, hi]
    d = h - np.where(lo > 0, psum[chunk, np.maximum(lo - 1, 0)], 0)
    scale = np.zeros((ns, num_rows))
    np.add.at(scale, (split, row), np.abs(d.astype(np.float64)))
    return want, scale


MATRICES = {
    # 4 monster rows of 4096 entries: 128 pieces each at L = 32
    "powerlaw_tail": lambda: r_mat.powerlaw_tail(4096, 4096 * 6, n_monster=4,
                                                 seed=2),
    "mixed_structure": lambda: r_mat.mixed_structure(2048, 2048 * 12,
                                                     seed=0),
}


@pytest.mark.parametrize("ns", [1, 8, 64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fixup_schedule_matches_reference_fixup(name, ns):
    # seg_from_csr (ns = 1) or split_from_csr, pieces sorted by the
    # per-format API's _piece_table, two padded piece rows in the table
    A = MATRICES[name]()
    L, B = 32, 2
    if ns == 1:
        f = r_ops.seg_from_csr(A, chunk=L, lane=L)
        vals, cols = f.vals, f.cols
        chunk, split = f.piece_chunk, np.zeros_like(f.piece_chunk)
    else:
        f = r_ops.split_from_csr(A, ns, chunk=L, lane=L)
        NS, Cs, _ = f.vals.shape
        assert NS == ns
        vals, cols = f.vals.reshape(NS * Cs, L), f.cols.reshape(NS * Cs, L)
        chunk, split = f.piece_split * Cs + f.piece_chunk, f.piece_split
    pad = np.array([0, 1, 0, 0, 0], np.int32)
    table = np.concatenate([np.stack([chunk, f.piece_lo, f.piece_hi,
                                      f.piece_row, split], 1), [pad, pad]])
    pcs, ptr = t_ops._piece_table("cpu", *table.T, L, A.nrows)
    assert (ptr[1:] - ptr[:-1]).max() > LONG_ROW
    x = np.random.default_rng(0).standard_normal((1, B, A.ncols)) \
        .astype(np.float32)
    x = np.ascontiguousarray(x.transpose(0, 2, 1))              # batch-minor
    sid = torch.zeros(1, dtype=torch.int32)
    psum = spmv_seg.seg_psum_plain(torch.from_numpy(vals[None]),
                                   torch.from_numpy(cols[None]),
                                   torch.from_numpy(x), sid,
                                   torch.empty((1, B) + vals.shape))
    shape = (1, B, ns, A.nrows) if ns > 1 else (1, B, A.nrows)
    got, plain = _fixup_both(psum, pcs[None], ptr[None], sid, sid, ns, shape)
    assert torch.equal(got, plain)
    for b in range(B):
        want, scale = _ref_fixup(psum[0, b].numpy(), *table.T, ns, A.nrows)
        err = np.abs(got[0, b].numpy().reshape(want.shape) - want)
        np.testing.assert_array_less(err, TOL * (1.0 + scale))


def test_fixup_schedule_on_the_executors_tables():
    # the executor's stacked tables: padded past each shard's real pieces,
    # seg and split (NS from split_meta) shards in one program
    A = r_mat.powerlaw_tail(2048, 2048 * 8, n_monster=3, seed=1)
    tp = t_program.lower(_port(A), TPlan(num_shards=2, kernel="seg",
                                         shard_kernels=("split", "seg")))
    run = t_program.make_program_spmv_fn(tp, device="cpu")
    x = np.random.default_rng(0).standard_normal((A.ncols, 2)) \
        .astype(np.float32)
    T = run.operands
    for pre, xbuf in zip(("loc_", "rem_"), run.buffers(tp.x_to_device(x))):
        args = [T[pre + k] for k in ("seg_vals", "seg_cols", "seg_pieces",
                                     "piece_ptr")]
        for fam, sids in run.families.items():
            psum = spmv_seg.seg_psum(args[0], args[1], xbuf, sids)
            n, B, R = sids.numel(), xbuf.shape[2], args[3].shape[1] - 1
            ns = 1 if fam == "seg" else int(run.num_splits[pre])
            ids = sids if fam == "seg" else torch.arange(n, dtype=torch.int32)
            shape = (2, B, R) if fam == "seg" else (n, B, ns, R)
            got, want = _fixup_both(psum, args[2], args[3], sids, ids, ns,
                                    shape)
            assert torch.equal(got, want)


# --------------------------------------------------------------------------
# (b) the per-chunk scan
# --------------------------------------------------------------------------

def emulate_seg_psum(vals, cols, x):
    """The kernel's order for one column: vals/cols (C, L), x (Lx,)."""
    C, L = vals.shape
    out = np.empty((C, L), np.float32)
    carry = np.zeros((C, 1), np.float32)
    lane = np.arange(WARP)
    for q in range(0, L, STEP):
        width = min(STEP, L - q)
        prod = (vals[:, q:q + width] * x[cols[:, q:q + width]]).reshape(
            C, width // 4, 4)
        s = prod.copy()
        for j in range(1, 4):                   # 4 serial products a lane
            s[..., j] = s[..., j - 1] + prod[..., j]
        incl = np.zeros((C, WARP), np.float32)
        incl[:, :width // 4] = s[..., 3]
        d = 1
        while d < WARP:                          # shuffle scan, old values
            up = np.zeros_like(incl)
            up[:, d:] = incl[:, :-d]
            incl = np.where(lane >= d, up + incl, incl)
            d *= 2
        excl = np.concatenate([np.zeros((C, 1), np.float32), incl[:, :-1]],
                              axis=1)
        base = carry + excl[:, :width // 4]
        o = base[..., None] + s
        out[:, q:q + width] = o.reshape(C, width)
        carry = o[:, -1, 3:]                     # lane 31's last value
    return out


@pytest.mark.parametrize("L", [32, 96, 128, 512, 1024])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_seg_psum_schedule_matches_pallas(name, L):
    A = MATRICES[name]()
    f = r_ops.seg_from_csr(A, chunk=L, lane=32)
    assert f.vals.shape[1] == L
    x = np.random.default_rng(1).standard_normal(A.ncols).astype(np.float32)
    got = emulate_seg_psum(f.vals, f.cols, x)
    want = r_seg_psum_pallas(f.vals, f.cols, jnp.asarray(x), interpret=True)
    scale = r_seg_psum_pallas(np.abs(f.vals), f.cols, jnp.asarray(np.abs(x)),
                              interpret=True)
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    np.testing.assert_array_less(err, TOL * (1.0 + np.asarray(scale)))
    plain = spmv_seg.seg_psum_plain(
        torch.from_numpy(f.vals[None]), torch.from_numpy(f.cols[None]),
        torch.from_numpy(x[None, :, None]), torch.zeros(1, dtype=torch.int32),
        torch.empty((1, 1) + f.vals.shape))
    err = np.abs(got - plain[0, 0].numpy()).astype(np.float64)
    np.testing.assert_array_less(err, TOL * (1.0 + np.asarray(scale)))
