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
  each, runs folded at each change of split and at the row's end; a
  block's long rows dealt to its warps and taken in super-rounds of
  ``SUPER`` pieces, their run segments summed a lane each and folded in
  order, a run that crosses a super-round carried; one store a row)
  against the plain version, every row of a launched shard written once,
  on that case and on :func:`long_rows_case` (rows of 3 to about 4,000
  pieces over 1 to NS splits);
* the executor on the CPU: both passes through one ``split_fixup`` each,
  none through ``seg_fixup`` or ``split_combine``, and y bitwise the
  executor run through the pair; its counters of the long-row path
  (``split.long_rows``, ``split.long_pieces``, ``split.long_runs``)
  against counts taken row by row from its piece tables.

Inputs are made with numpy from a seed.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch import tracing
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


LONG_ROW, LONG_LOADS, FIXUP_WARPS, SUPER = (_const(c) for c in (
    "LONG_ROW", "LONG_LOADS", "FIXUP_WARPS", "SUPER"))
ROUND = LONG_LOADS * WARP
RHS_CHUNK = int(re.search(r"constexpr int RHS_CHUNK = (\d+);",
                          (_lib.CSRC / "common.cuh").read_text()).group(1))


def _row_splits(ns, rng):
    """The split sequences of the rows the case must hold, each sorted:
    at and past ``LONG_ROW``, long rows whose split changes exactly at a
    round boundary (piece ROUND, 2 * ROUND of the row), one piece after it,
    or at every piece, and at a super-round boundary (piece SUPER): a run
    that ends there, a run of one piece that ends there, a run that goes
    one piece past it, and random runs across two boundaries."""
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
        [a] * SUPER + [b] * 7,                         # at SUPER
        [a] * (SUPER - 1) + [b] + [c] * 5,
        [b] * (SUPER + 1) + [c] * 2,
        list(np.sort(rng.integers(0, ns, 2 * SUPER + 77))),
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


def long_rows_case(B, *, seed=0, S=2, R=40, C=32, L=64, ns=64):
    """Long rows only: psum (2, B, C, L) of shards sids = [1, 0] of S, the
    piece tables (S, Pp, 5) padded with [0, 1, 0, 0, 0], and piece_ptr
    (S, R+1).  A shard's rows take 3 to about 4,000 pieces (LONG_ROW + 1,
    SUPER - 1, SUPER, SUPER + 1 and 2 * SUPER + 1 among them, the rest
    log-uniform) over 1 to ``ns`` splits (a row's splits drawn from a
    random subset of that size, sorted), one row a piece a split (runs of
    one piece), and a sixth of the pieces padded (lo > hi)."""
    rng = np.random.default_rng(seed)
    one = max(min(ns, 40), LONG_ROW + 1)       # the row of one-piece runs
    counts = [[LONG_ROW + 1, SUPER - 1, SUPER, SUPER + 1, 2 * SUPER + 1, one]
              + list(np.exp(rng.uniform(np.log(3), np.log(4000), R - 6))
                     .astype(int)) for _ in range(S)]
    tables = []
    for s in range(S):
        recs = []
        for r, c in enumerate(counts[s]):
            if r == 5:                  # a split a piece, where ns allows
                sp = np.sort(rng.choice(ns, c, replace=c > ns))
            else:
                used = rng.choice(ns, rng.integers(1, ns + 1), replace=False)
                sp = np.sort(rng.choice(used, c))
            a, b = rng.integers(0, L, (2, c))
            lo = np.where(rng.random(c) < 0.3, 0, np.minimum(a, b))
            hi = np.maximum(a, b)
            pad = rng.random(c) < 1 / 6
            lo, hi = np.where(pad, 1, lo), np.where(pad, 0, hi)
            recs.append(np.stack([rng.integers(0, C, c), lo, hi,
                                  np.full(c, r), sp], 1))
        tables.append(np.concatenate(recs).astype(np.int32))
    Pp = max(len(t) for t in tables) + 3
    pieces = np.tile(np.array([0, 1, 0, 0, 0], np.int32), (S, Pp, 1))
    ptr = np.zeros((S, R + 1), np.int32)
    for s, t in enumerate(tables):
        pieces[s, :len(t)] = t
        ptr[s] = np.searchsorted(t[:, 3], np.arange(R + 1))
    psum = (rng.standard_normal((2, B, C, L))
            * 10.0 ** rng.uniform(-3, 3, (2, B, C, L))).astype(np.float32)
    return (torch.from_numpy(psum), torch.from_numpy(pieces),
            torch.from_numpy(ptr), torch.tensor([1, 0], dtype=torch.int32))


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
    its FIXUP_WARPS warps in turn and walked in super-rounds of SUPER
    pieces (ROUND at RHS_CHUNK columns, B > 1): the super-round's run
    segments (a change of split starts one, and so does piece 0) are
    dealt WARP // NB at a time to the lanes, a segment and column a lane,
    each summed in piece order from +0, or, for a segment 0 that goes on
    with the run the super-round before ended in, from that run's carried
    sum; then the finished segments are added to the row sum in order and
    the last one carried (a carried run that ended is added first); the
    row's last run at its end, one store.  Returns ``out`` and how often
    each (shard, row) was stored."""
    psum, pcs, ptr = psum.numpy(), pieces.numpy(), piece_ptr.numpy()
    out = out.numpy()
    B, R = psum.shape[1], ptr.shape[1] - 1
    wps = -(-R // WARP)
    zero = np.zeros(B, np.float32)
    stores = np.zeros((out.shape[0], R), int)
    nb = 1 if B == 1 else RHS_CHUNK               # columns a thread keeps
    sp_pieces, slots = (SUPER if nb == 1 else ROUND), WARP // nb

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
            row, carry, t = zero, zero, -1
            for base in range(p, pe, sp_pieces):    # a super-round
                staged = [piece(k, q)
                          for q in range(base, min(base + sp_pieces, pe))]
                splits = [sp for sp, _ in staged]
                starts = [i for i, sp in enumerate(splits)
                          if i == 0 or sp != splits[i - 1]]
                ends = starts[1:] + [len(staged)]
                cont = splits[0] == t
                if not cont:
                    row = row + carry               # +0 at the row's start
                sums = []
                for w0 in range(0, len(starts), slots):     # a lane each
                    for seg in range(w0, min(w0 + slots, len(starts))):
                        acc = carry if seg == 0 and cont else zero
                        for i in range(starts[seg], ends[seg]):
                            acc = acc + staged[i][1]
                        sums.append(acc)
                for v in sums[:-1]:                 # the fold, in order
                    row = row + v
                carry, t = sums[-1], splits[-1]
            store(k, r, row + carry)
    return torch.from_numpy(out), stores


@pytest.mark.parametrize("B", [1, 3, 8])
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


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("ns", [1, 7, 64])
def test_kernel_schedule_on_long_rows_is_bitwise_the_plain_version(ns, B):
    # rows of 3 to about 4,000 pieces, at and across super-round
    # boundaries, runs of one piece, padded pieces among the real ones
    psum, pcs, ptr, sids = long_rows_case(B, seed=ns, ns=ns)
    lengths = (ptr[:, 1:] - ptr[:, :-1]).flatten()
    assert lengths.min() > LONG_ROW and lengths.max() > 2 * SUPER
    o = sids.long()
    got, stores = emulate_split_fixup(psum, pcs, ptr, sids, ns,
                                      _nan(psum, ptr, S=2))
    want = spmv_split.split_fixup_plain(psum, pcs, ptr, sids, ns,
                                        _nan(psum, ptr, S=2))
    assert (stores == 1).all()
    assert torch.equal(_bits(got), _bits(want))


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


def test_long_row_is_the_kernels():
    assert ops.LONG_ROW == LONG_ROW


def _hand_long_rows(d, pre, shards):
    """A pass's rows of more than LONG_ROW pieces in ``shards``, their
    pieces and their runs, row by row from the pass's ``piece_ptr`` and
    piece table (with one split a row is one run)."""
    rows = pieces = runs = 0
    for s in shards:
        ptr, pcs = d[pre + "piece_ptr"][s], d[pre + "seg_pieces"][s]
        for r in range(len(ptr) - 1):
            n = int(ptr[r + 1] - ptr[r])
            if n <= LONG_ROW:
                continue
            split = pcs[ptr[r]:ptr[r + 1], 4].tolist() \
                if d["NS_" + pre[:-1]] > 1 else [0] * n
            rows, pieces = rows + 1, pieces + n
            runs += 1 + sum(a != b for a, b in zip(split[1:], split[:-1]))
    return rows, pieces, runs


@pytest.mark.parametrize("B", [1, 8])
def test_long_row_counters_are_the_hand_counts(tail_prog, B):
    # a recorded call counts the split fix-up's long rows, their pieces
    # and runs, both passes, whatever B; another call as many again
    A, prog = tail_prog
    d = P._device_operands(prog)
    shards = [k for k, st in enumerate(prog.stages) if st.kernel == "split"]
    want = [sum(c) for c in zip(*(_hand_long_rows(d, pre, shards)
                                  for pre in ("loc_", "rem_")))]
    assert 0 < want[0] < want[2] < want[1]      # rows over several splits
    keys = [f"split.long_{k}" for k in ("rows", "pieces", "runs")]
    run = P.make_program_spmv_fn(prog, device="cpu")
    x = np.random.default_rng(3).standard_normal((A.ncols, B))
    xs = torch.from_numpy(prog.x_to_device(x.astype(np.float32)))
    tracing.reset()
    try:
        tracing.enable()
        run(xs)
        assert [tracing.counter(k) for k in keys] == want
        run(xs)
        assert [tracing.counter(k) for k in keys] == [2 * c for c in want]
    finally:
        tracing.reset()
