"""The split family's fused fix-up and combine (``split_fixup``).

The fused op sums each run of a row's pieces in one split in piece order
from 0, then the row's runs in split order from 0, straight into y.  The
pair it replaces, ``seg_fixup`` into (n, B, NS, R) partials and then
``split_combine``, adds a +0 for every split a row has no pieces in;
adding +0 changes nothing but a -0, and a sum that starts at +0 in
round-to-nearest is never -0, so the two are held bitwise here:

* the plain version against the plain pair, over rows of every kind (none,
  padded, at and just past ``LONG_ROW``, long rows whose split changes at
  a round boundary of ``LONG_LOADS`` * 32 pieces, runs of -0 differences)
  for NS 1, 7, 64 and B 1, 3, 8, 11;
* an emulation of the kernel's schedule with ``to_y`` (short rows a lane
  each, a block's long rows dealt to its warps and walked in rounds, runs
  folded at each change of split and at the row's end; one store a row)
  against the plain version, every row of a launched shard written once;
* the executor on the CPU: both passes through one ``split_fixup`` each,
  none through ``seg_fixup`` or ``split_combine``, and y bitwise the
  executor run through the pair.

Inputs are made with numpy from a seed.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import program as P
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data import matrices as mats
from repro_torch.kernels import _lib, ops, spmv_seg, spmv_split

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

WARP = 32
_SRC = (_lib.CSRC / "spmv_seg.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


LONG_ROW, LONG_LOADS, FIXUP_WARPS = (_const(c) for c in (
    "LONG_ROW", "LONG_LOADS", "FIXUP_WARPS"))
ROUND = LONG_LOADS * WARP


def _row_splits(ns, rng):
    """The split sequences of the rows the case must hold, each sorted:
    at and past ``LONG_ROW``, and long rows whose split changes exactly at
    a round boundary (piece ROUND, 2 * ROUND of the row), one piece after
    it, or at every piece."""
    a, b, c, d = np.sort(rng.choice(ns, 4, replace=False)) if ns >= 4 \
        else (0, 0, 0, 0)
    return [
        [a] * LONG_ROW, [a, b] + [b] * (LONG_ROW - 2), [a] * (LONG_ROW + 1),
        [a] * LONG_ROW + [b],
        [a] * ROUND + [b] * ROUND + [c] * 40,          # at round boundaries
        [a] * ROUND + [b] + [c] * (ROUND - 1) + [d] * 3,
        [a] * (ROUND - 1) + [b] * (ROUND + 1),
        list(np.sort(rng.integers(0, ns, 3 * ROUND + 17))),
        [c] * 1037,
    ]


def split_fixup_case(ns, B, *, seed=0, S=3, R=200, C=24, L=64):
    """The split fix-up's operands on the CPU: psum (2, B, C, L) of the
    shards sids = [2, 0] of S (spread over six decades, so that another
    order of adds shows), each shard's row-ordered piece table (S, Pp, 5)
    padded past its real pieces with [0, 1, 0, 0, 0], and piece_ptr
    (S, R+1).  Row 0 starts with two padded piece rows; the rows of
    :func:`_row_splits` sit at random places; the last 24 rows of a shard
    have no pieces (the padding to R); two rows take their pieces from
    chunk C - 1, whose psum is all -0, so their differences are -0 (a run
    of them sums to +0 from +0); the other rows take 0 to 3 pieces.  With
    NS = 1 every split is 0, as the executor's local pass has it."""
    rng = np.random.default_rng(seed)
    kinds = _row_splits(ns, rng)
    pad = np.array([[0, 1, 0, 0, 0]] * 2)
    tables = []
    for _ in range(S):
        splits = [list(np.sort(rng.integers(0, ns, c)))
                  for c in rng.choice([0, 0, 0, 1, 1, 2, 3], size=R)]
        for r in range(R - 24, R):
            splits[r] = []
        at = rng.choice(np.arange(1, R - 24), len(kinds) + 2, replace=False)
        for r, sp in zip(at, kinds):
            splits[r] = sp
        neg = set(at[len(kinds):].tolist())
        for r in neg:
            splits[r] = [0, 0] if r % 2 else [0] * (LONG_ROW + 3)
        recs = [pad]
        for r, sp in enumerate(splits):
            c = len(sp)
            a, b = rng.integers(0, L, (2, c))
            lo = np.where(rng.random(c) < 0.3, 0, np.minimum(a, b))
            chunk = rng.integers(0, C - 1, c)
            if r in neg:
                chunk, lo = np.full(c, C - 1), np.zeros(c, int)
            recs.append(np.stack([chunk, lo, np.maximum(a, b), np.full(c, r),
                                  np.asarray(sp, int) if ns > 1
                                  else np.zeros(c, int)], 1))
        tables.append(np.concatenate(recs).astype(np.int32))
    Pp = max(len(t) for t in tables) + 5
    pieces = np.tile(np.array([0, 1, 0, 0, 0], np.int32), (S, Pp, 1))
    ptr = np.zeros((S, R + 1), np.int32)
    for s, t in enumerate(tables):
        pieces[s, :len(t)] = t
        ptr[s] = np.searchsorted(t[:, 3], np.arange(R + 1))
    psum = (rng.standard_normal((2, B, C, L))
            * 10.0 ** rng.uniform(-3, 3, (2, B, C, L))).astype(np.float32)
    psum[:, :, C - 1] = -0.0
    return (torch.from_numpy(psum), torch.from_numpy(pieces),
            torch.from_numpy(ptr), torch.tensor([2, 0], dtype=torch.int32))


def pair_plain(psum, pieces, piece_ptr, sids, ns, out):
    """``seg_fixup_plain`` into (n, B, NS, R) partials, then
    ``split_combine_plain`` into ``out``."""
    n, B = psum.shape[:2]
    part = torch.full((n, B, ns, piece_ptr.shape[1] - 1), float("nan"))
    spmv_seg.seg_fixup_plain(psum, pieces, piece_ptr, sids,
                             torch.arange(n, dtype=torch.int32), part)
    return spmv_split.split_combine_plain(part, sids, out)


def _nan(psum, piece_ptr, S=3):
    return torch.full((S, psum.shape[1], piece_ptr.shape[1] - 1),
                      float("nan"))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("ns", [1, 7, 64])
def test_plain_fused_fixup_is_bitwise_the_pair(ns, B):
    psum, pcs, ptr, sids = split_fixup_case(ns, B)
    lengths = (ptr[:, 1:] - ptr[:, :-1]).flatten()
    for size in (0, LONG_ROW, LONG_ROW + 1, 2 * ROUND + 40, 1037):
        assert (lengths == size).any()
    o = sids.long()
    got = spmv_split.split_fixup_plain(psum, pcs, ptr, sids, ns,
                                       _nan(psum, ptr))
    want = pair_plain(psum, pcs, ptr, sids, ns, _nan(psum, ptr))
    assert not got[o].isnan().any()
    assert torch.equal(_bits(got[o]), _bits(want[o]))
    assert got[1].isnan().all()                 # shard 1 was not listed
    # the wrapper on CPU tensors is the plain version
    via = spmv_split.split_fixup(psum, pcs, ptr, sids, num_splits=ns,
                                 out=_nan(psum, ptr))
    assert torch.equal(_bits(via[o]), _bits(got[o]))


@pytest.mark.parametrize("ns", [1, 7, 64])
def test_runs_of_negative_zeros_read_positive_zero(ns):
    # a short and a long row of -0 differences in each listed shard: +0
    psum, pcs, ptr, sids = split_fixup_case(ns, 2)
    last = psum.shape[2] - 1
    got = spmv_split.split_fixup_plain(psum, pcs, ptr, sids, ns,
                                       _nan(psum, ptr))
    for s in sids.tolist():
        rows = [r for r in range(ptr.shape[1] - 1) if ptr[s, r + 1] > ptr[s, r]
                and (pcs[s, ptr[s, r]:ptr[s, r + 1], 0] == last).all()]
        assert len(rows) == 2
        assert not _bits(got[s][:, rows]).any()         # +0, not -0


def emulate_split_fixup(psum, pieces, piece_ptr, sids, ns, out):
    """``seg_fixup_kernel`` with ``to_y``, every column at once: a warp
    owns 32 rows of a shard; a lane walks its row when it has at most
    LONG_ROW pieces (runs restarted at each change of split and folded
    into the row's sum, the last one at the row's end; one store), a long
    row's lane stores nothing; then the block's long rows are dealt to
    its FIXUP_WARPS warps in turn and walked in rounds of ROUND pieces,
    lane b folding column b's runs across rounds, one store at the end.
    Returns ``out`` and how often each (shard, row) was stored."""
    psum, pcs, ptr = psum.numpy(), pieces.numpy(), piece_ptr.numpy()
    out = out.numpy()
    B, R = psum.shape[1], ptr.shape[1] - 1
    wps = -(-R // WARP)
    zero = np.zeros(B, np.float32)
    stores = np.zeros((out.shape[0], R), int)

    def piece(k, q):
        chunk, lo, hi, _, split = pcs[sids[k], q]
        split = split if ns > 1 else 0
        if lo > hi:
            return split, zero
        h = psum[k, :, chunk, hi]
        return split, h - psum[k, :, chunk, lo - 1] if lo > 0 else h

    def store(k, r, v):
        out[sids[k], :, r] = v
        stores[sids[k], r] += 1

    n_warps = len(sids) * wps
    for blk in range(-(-n_warps // FIXUP_WARPS)):
        rows = [(w // wps, (w % wps) * WARP + lane)
                for w in range(blk * FIXUP_WARPS,
                               min(blk * FIXUP_WARPS + FIXUP_WARPS, n_warps))
                for lane in range(WARP) if (w % wps) * WARP + lane < R]
        spans = {(k, r): (int(ptr[sids[k], r]), int(ptr[sids[k], r + 1]))
                 for k, r in rows}
        longs = [(k, r) for k, r in rows
                 if spans[k, r][1] - spans[k, r][0] > LONG_ROW]
        for k, r in rows:                           # short rows first
            p, pe = spans[k, r]
            if pe - p > LONG_ROW:
                continue                            # a long row's lane
            acc, total, prev = zero, zero, None
            for j in range(pe - p):
                split, d = piece(k, p + j)
                if j and split != prev:
                    total, acc = total + acc, zero
                acc, prev = acc + d, split
            store(k, r, total + acc)
        for k, r in longs:                          # then the long rows
            p, pe = spans[k, r]
            acc, total, t = zero, zero, -1
            for base in range(p, pe, ROUND):
                for q in range(base, min(base + ROUND, pe)):
                    split, d = piece(k, q)
                    if split != t:
                        total = total + acc         # +0 at the first piece
                    acc = (acc if split == t else zero) + d
                    t = split
            store(k, r, total + acc)
    return torch.from_numpy(out), stores


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("ns", [1, 7, 64])
def test_kernel_schedule_is_bitwise_the_plain_version(ns, B):
    psum, pcs, ptr, sids = split_fixup_case(ns, B, seed=1)
    o = sids.long()
    got, stores = emulate_split_fixup(psum, pcs, ptr, sids, ns,
                                      _nan(psum, ptr))
    want = spmv_split.split_fixup_plain(psum, pcs, ptr, sids, ns,
                                        _nan(psum, ptr))
    assert (stores[o] == 1).all() and not stores[1].any()
    assert torch.equal(_bits(got[o]), _bits(want[o]))


@pytest.fixture(scope="module")
def tail_prog():
    A = mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)
    return A, P.lower(A, SpmvPlan(num_shards=4, kernel="split"))


@pytest.mark.parametrize("B", [1, 8])
def test_executor_runs_one_fused_fixup_a_pass(tail_prog, monkeypatch, B):
    # each call: one split_fixup a pass into the pass's y, nothing through
    # the partials path; y bitwise the executor run through the pair
    A, prog = tail_prog
    assert set(prog.shard_kernels()) == {"split"}
    xs = torch.from_numpy(prog.x_to_device(np.random.default_rng(2)
                                           .standard_normal((A.ncols, B))
                                           .astype(np.float32)))
    fused = []

    def recorded(psum, pieces, piece_ptr, sids, *, num_splits, out):
        fused.append((num_splits, tuple(out.shape)))
        return spmv_split.split_fixup(psum, pieces, piece_ptr, sids,
                                      num_splits=num_splits, out=out)

    def refused(*a, **kw):
        raise AssertionError("the executor ran the partials path")

    monkeypatch.setattr(ops, "split_fixup", recorded)
    monkeypatch.setattr(spmv_seg, "seg_fixup", refused)
    monkeypatch.setattr(spmv_split, "split_combine", refused)
    y = P.make_program_spmv_fn(prog, device="cpu")(xs)
    d = P._device_operands(prog)
    shape = (prog.plan.num_shards, B, d["R"])
    assert sorted(fused) == sorted([(d["NS_loc"], shape),
                                    (d["NS_rem"], shape)])
    assert d["NS_rem"] > 1
    monkeypatch.undo()
    monkeypatch.setattr(ops, "_split_fixup_combine", pair_plain)
    want = P.make_program_spmv_fn(prog, device="cpu")(xs)
    assert torch.equal(_bits(y), _bits(want))
