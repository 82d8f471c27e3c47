"""The port's CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU with ``nvcc``; skips without one.  Run on a GPU host:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import json
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import program as P
from repro_torch.core.sparse_matrix import csr_from_coo, csr_matvec, \
    csr_to_bcsr
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data import matrices as mats
from repro_torch.kernels import _lib, exchange, ops, spmv_ell, spmv_seg, \
    spmv_split, spmv_tile

from test_torch_split_fixup import long_rows_case, split_fixup_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


PLANS = {
    "mixed": dict(num_shards=8, shard_kernels=(
        "tile", "tile", "tile", "ell", "hyb", "seg", "split", "seg"),
        split_counts=(1, 1, 1, 1, 1, 1, 4, 1),
        shard_exchanges=("halo", "allgather") * 4),
    "split": dict(num_shards=4, kernel="split"),
    "ell-cyclic": dict(num_shards=4, kernel="ell", layout="cyclic",
                       exchange="allgather"),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_card_matches_plain_path(device, name):
    A = mats.blocked_band(4096, 4096 * 24, seed=0) if name == "mixed" \
        else mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)
    prog = P.lower(A, SpmvPlan(**PLANS[name]))
    x = np.random.default_rng(0).standard_normal((A.ncols, 4))
    _lib.reset_launch_counts()
    got = P.execute(prog, x, backend="device", device=device)
    assert sum(_lib.launch_counts.values()) > 0
    plain = P.execute(prog, x, backend="device", device="cpu")
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, csr_matvec(A, x), rtol=2e-4, atol=2e-4)
    xs = torch.from_numpy(prog.x_to_device(x.astype(np.float32))).to(device)
    y = P.make_program_spmv_fn(prog, device=device)(xs)
    y_serial = P.make_program_spmv_fn(prog, device=device,
                                      pipeline=False)(xs)
    assert torch.equal(y, y_serial)
    y0 = P.make_program_spmv_fn(prog, device=device)(xs[..., 0])
    assert torch.equal(y[..., 0], y0)


def test_executor_allocates_only_its_operands(device):
    # powerlaw_tail.solve's plan on 2^16 rows: building the executor
    # allocates run.operands, the shard ids of its families and the
    # exchange's index, and nothing else (no ELL or tile slab, no seg_rows)
    A = mats.powerlaw_tail(1 << 16, (1 << 16) * 16, n_monster=8, seed=0)
    prog = P.lower(A, SpmvPlan(
        num_shards=8, kernel="seg", distribution="nonzero", exchange="halo",
        shard_kernels=("split",) * 4 + ("seg",) * 4,
        split_counts=(64,) * 4 + (1,) * 4))
    index = P._exchange_index(prog, P._device_operands(prog))
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_stats(device)["requested_bytes.all.current"]
    run = P.make_program_spmv_fn(prog, device=device)
    torch.cuda.synchronize(device)
    got = torch.cuda.memory_stats(device)["requested_bytes.all.current"] \
        - before
    assert set(run.families) == {"split", "seg"}
    assert not any(k.endswith(("ell_data", "tile_data", "seg_rows"))
                   for k in run.operands)
    tensors = [*run.operands.values(), *run.families.values()]
    assert got == sum(t.numel() * t.element_size() for t in tensors) \
        + index.nbytes


def _card_and_plain(kernel, plain, args, abs_args):
    """One launch of ``kernel`` on the card, counted, against its plain
    version on the same inputs (rtol = atol = 1e-5 on |A|.|x|)."""
    _lib.reset_launch_counts()
    got = kernel(*args)
    torch.cuda.synchronize()
    assert sum(_lib.launch_counts.values()) == 1
    want = plain(*args, torch.empty_like(got))
    scale = plain(*abs_args, torch.empty_like(got))
    assert bool(((got - want).abs() <= 1e-5 * (1.0 + scale)).all())


def _x(n, B):
    return np.random.default_rng(1).standard_normal((n, B)).astype(np.float32)


@pytest.mark.parametrize("ns", [8, 64])
def test_split_psum_and_split_spmv_on_card(device, ns):
    A = mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)
    spl = ops.split_from_csr(A, ns)
    vals, cols = (torch.from_numpy(a).to(device) for a in (spl.vals,
                                                          spl.cols))
    x = _x(A.ncols, 3)
    xb = torch.from_numpy(x).to(device)
    _card_and_plain(spmv_split.split_psum, spmv_split.split_psum_plain,
                    (vals, cols, xb), (vals.abs(), cols, xb.abs()))
    y = ops.split_spmv(spl, x, device=device)
    np.testing.assert_allclose(y.cpu(), csr_matvec(A, x), rtol=2e-4,
                               atol=2e-4)
    for b in range(3):
        assert torch.equal(y[:, b], ops.split_spmv(spl, x[:, b].copy(),
                                                   device=device))


def _cut_tail():
    # 4000 columns, so the last x block is cut (4000 % 128 != 0); rows
    # 800-1599 emptied, so whole block rows have no tiles
    P = mats.powerlaw_tail(4000, 4000 * 8, n_monster=2, seed=0)
    rows = np.repeat(np.arange(4000), np.diff(P.row_ptr))
    keep = (rows < 800) | (rows >= 1600)
    return csr_from_coo(rows[keep], P.col_index[keep], P.values[keep],
                        P.shape)


def _stored_zeros(A, every=7):
    """A with every 7th entry an explicit zero (kept in every format)."""
    vals = A.values.copy()
    vals[::every] = 0.0
    return dataclasses.replace(A, values=vals)


@pytest.mark.parametrize("bm", [8, 16, 128])
def test_tile_walk_and_tile_spmv_on_card(device, bm):
    A = _cut_tail()
    t = ops.tile_from_csr(A, bm=bm)
    assert (np.diff(t.tile_ptr) == 0).any()
    data, tcols, tptr, mask = (torch.from_numpy(a).to(device) for a in (
        t.data, t.tile_cols, t.tile_ptr, t.mask))
    x = _x(A.ncols, 3)
    xb = torch.from_numpy(x).to(device)
    _card_and_plain(
        lambda *a: spmv_tile.tile_walk_spmv(*a, mask=mask),
        spmv_tile.tile_walk_spmv_plain, (data, tcols, tptr, xb),
        (data.abs(), tcols, tptr, xb.abs()))
    y = ops.tile_spmv(t, x, device=device)
    np.testing.assert_allclose(y.cpu(), csr_matvec(A, x), rtol=2e-4,
                               atol=2e-4)
    for b in range(3):
        assert torch.equal(y[:, b], ops.tile_spmv(t, x[:, b].copy(),
                                                  device=device))


def contrib_case(B, *, shared_x=False, seed=0, Rb=40, Lx=300):
    """``tile_contrib``'s flat operands on the CPU, as the executor stacks
    them: data (4, Tp, 8, 128), xcol, brow, tile_ptr, x ((1 or 4), Lx, B),
    the listed shards ``sids = [2, 1, 0]``, ``rb_used`` and Rb.

    Shard 0 has a block row of 64 tiles, empty block rows among its others
    and tiles up to block row 29; shard 1 has no tiles; shard 2 reaches
    block row 33, so rb_used = 34 < Rb.  Shard 3, not listed, has a tile at
    block row 38.  About a fifth of the cells are zeros, a lane whose 8
    cells are all zero reads x position 0 (as the executor's remap gives
    it), and the padding tiles past each shard's real ones (block row Rb)
    hold NaN, so a read of one would show."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((4, Rb), int)
    counts[0, :30] = rng.choice([0, 0, 1, 2, 3, 5], 30)
    counts[0, 3], counts[0, 29] = 64, 2
    counts[2, [0, 7, 33]] = (1, 4, 2)
    counts[3, 38] = 1
    Tp = counts.sum(1).max() + 5
    data = np.full((4, Tp, 8, 128), np.nan, np.float32)
    xcol = np.zeros((4, Tp, 128), np.int32)
    brow = np.full((4, Tp), Rb, np.int32)
    for s in range(4):
        n = counts[s].sum()
        d = rng.standard_normal((n, 8, 128)).astype(np.float32)
        d[rng.random(d.shape) < 0.2] = 0.0
        live = (d != 0).any(axis=1)
        data[s, :n] = d
        xcol[s, :n] = np.where(live, rng.integers(0, Lx, (n, 128)), 0)
        brow[s, :n] = np.repeat(np.arange(Rb), counts[s])
    tile_ptr = np.stack([np.searchsorted(b, np.arange(Rb + 1)) for b in brow])
    x = rng.standard_normal((1 if shared_x else 4, B, Lx)).astype(np.float32)
    x = np.ascontiguousarray(x.transpose(0, 2, 1))              # batch-minor
    sids = torch.tensor([2, 1, 0], dtype=torch.int32)
    return ([torch.from_numpy(a) for a in (data, xcol, brow,
                                           tile_ptr.astype(np.int32), x)]
            + [sids, 34, Rb])


@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8, 11])
def test_tile_contrib_on_card(device, B, shared_x):
    # padding tiles (NaN, never read), a shard with no tiles, empty block
    # rows below rb_used, a block row of 64 tiles; out starts as NaN, so an
    # entry the kernel does not write shows, and shard 3 is not listed
    data, xcol, brow, tile_ptr, x, sids, rb_used, Rb = contrib_case(
        B, shared_x=shared_x)
    args = [t.to(device) for t in (data, xcol, brow, tile_ptr)]
    xd, sd = x.to(device), sids.to(device)

    rows = sids.long()

    def contrib(v, rb=rb_used):
        out = torch.full((4, v.shape[2], Rb * 8), float("nan"), device=device)
        return spmv_tile.tile_contrib(*args, v, sd, rb_used=rb, out=out)
    _lib.reset_launch_counts()
    got = contrib(xd).cpu()
    assert _lib.launch_counts["tile_contrib"] == 1
    want = spmv_tile.tile_contrib_plain(data, xcol, brow, x, sids,
                                        torch.zeros(got.shape))
    scale = spmv_tile.tile_contrib_plain(data.abs(), xcol, brow, x.abs(),
                                         sids, torch.zeros(got.shape))
    assert bool((got[rows] - want[rows]).abs().le(
        1e-5 * (1.0 + scale[rows])).all())
    assert not got[rows, :, rb_used * 8:].any()
    assert got[3].isnan().all()
    _columns_match_single(lambda v: contrib(v)[rows], xd, 1)
    assert torch.equal(contrib(xd).cpu()[rows], got[rows])
    # the same sums when every block row is walked (rb_used = Rb)
    assert torch.equal(contrib(xd, None).cpu()[rows], got[rows])


def test_tile_contrib_rejects_unaligned_operands(device):
    data, xcol, brow, tile_ptr, x, sids, rb_used, Rb = contrib_case(1)
    args = [t.to(device) for t in (data, xcol, brow, tile_ptr, x, sids)]
    flat = torch.empty(args[0].numel() + 1, device=device)
    shifted = flat[1:].view(args[0].shape)       # 4 bytes off 16
    shifted.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte"):
        spmv_tile.tile_contrib(shifted, *args[1:], rb_used=rb_used)
    out = torch.empty(args[0].shape[0] * (Rb * 8) + 1, device=device)
    with pytest.raises(ValueError, match="16-byte"):
        spmv_tile.tile_contrib(*args, rb_used=rb_used,
                               out=out[1:].view(4, 1, Rb * 8))


def _columns_match_single(kernel, xb, col_dim):
    """Every column of the batched call equals the single-vector call on
    it, bitwise; xb is batch-minor (its last dimension the batch) and the
    result has the batch at ``col_dim``."""
    got = kernel(xb)
    for b in range(xb.shape[-1]):
        one = kernel(xb[..., b:b + 1].contiguous())
        assert torch.equal(got.narrow(col_dim, b, 1), one)


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("bm", [8, 16, 128])
def test_tile_walk_reads_only_occupied_cells(device, bm, B):
    # stored zeros, block rows without tiles, a cut last x block, and a
    # column (`hole`) no row has an entry in; B = 11 spans two chunks of 8
    # columns
    C = _stored_zeros(_cut_tail())
    rows = np.repeat(np.arange(C.nrows), np.diff(C.row_ptr))
    hole = 130
    keep = C.col_index != hole
    A = csr_from_coo(rows[keep], C.col_index[keep], C.values[keep], C.shape)
    t = ops.tile_from_csr(A, bm=bm)
    assert (t.tile_cols == hole // 128).any() and (A.values == 0).any()
    data, tcols, tptr, mask = (torch.from_numpy(a).to(device) for a in (
        t.data, t.tile_cols, t.tile_ptr, t.mask))
    x = _x(A.ncols, B)
    xb = torch.from_numpy(x).to(device)

    def walk(v):
        return spmv_tile.tile_walk_spmv(data, tcols, tptr, v, mask=mask)
    _card_and_plain(lambda *a: walk(a[3]), spmv_tile.tile_walk_spmv_plain,
                    (data, tcols, tptr, xb),
                    (data.abs(), tcols, tptr, xb.abs()))
    _columns_match_single(walk, xb, 0)
    # CSR semantics: a non-finite x in an unoccupied cell is never read
    poisoned = xb.clone()
    poisoned[hole] = float("inf")
    zeroed = xb.clone()
    zeroed[hole] = 0.0
    assert torch.equal(walk(poisoned), walk(zeroed))


@pytest.mark.parametrize("shape", [(8, 128), (16, 16), (5, 10), (16, 6)])
def test_bell_shim_null_mask_on_card(device, shape):
    # the Block-ELL slab has no mask: every cell is read, zero-padded
    # block slots included; (8, 128) takes the fast walk, the others the
    # general one, 16-byte loads at bn % 4 == 0 and 4-byte ones else
    A = _stored_zeros(_cut_tail())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        blocks, bcols = ops.bell_from_bcsr(csr_to_bcsr(A, shape))
        X = _x(A.ncols, 11)
        Y = ops.bell_spmm(blocks, bcols, X, device=device)
        Y_cpu = ops.bell_spmm(blocks, bcols, X, device="cpu")
        np.testing.assert_allclose(Y.cpu(), Y_cpu, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(Y.cpu()[:A.nrows], csr_matvec(A, X),
                                   rtol=2e-4, atol=2e-4)
        for b in (0, 5, 10):
            y1 = ops.bell_spmv(blocks, bcols, X[:, b].copy(), device=device)
            assert torch.equal(Y[:, b], y1)


ELL_PLANS = {
    "hyb-halo": dict(num_shards=2, kernel="hyb", exchange="halo"),
    "ell-cyclic": dict(num_shards=2, kernel="ell", layout="cyclic",
                       exchange="allgather"),
}


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("plan", sorted(ELL_PLANS))
def test_ell_reads_only_real_slots(device, plan, B):
    # stored zeros, rows of length 0 (the other pass's rows), HYB overflow
    A = _stored_zeros(mats.powerlaw_tail(1024, 1024 * 12, n_monster=4,
                                         seed=0))
    prog = P.lower(A, SpmvPlan(**ELL_PLANS[plan]))
    run = P.make_program_spmv_fn(prog, device=device)
    x = torch.from_numpy(prog.x_to_device(_x(A.ncols, B))).to(device)
    T = run.operands
    (fam, sids), = run.families.items()
    for pre, xbuf in zip(("loc_", "rem_"), run.buffers(x)):
        a = [T[pre + k] for k in ("ell_data", "ell_cols", "ovf_rows",
                                  "ovf_cols", "ovf_vals", "ovf_ptr")]
        ell_len = T[pre + "ell_len"]
        assert (ell_len == 0).any()

        def kernel(v):
            return spmv_ell.ell_spmv(*a, v, sids, ell_len=ell_len)
        absa = [a[0].abs()] + a[1:4] + [a[4].abs(), a[5]]
        _card_and_plain(lambda *args: kernel(args[6]),
                        spmv_ell.ell_spmv_plain, (*a, xbuf, sids),
                        (*absa, xbuf.abs(), sids))
        _columns_match_single(kernel, xbuf, 1)
    y = run(x)
    np.testing.assert_allclose(P.gather_b(prog, y),
                               csr_matvec(A, _x(A.ncols, B)), rtol=2e-4,
                               atol=2e-4)


def test_ell_api_reads_every_slot_on_card(device):
    # the per-format API passes no length table: every slot is real
    A = _stored_zeros(mats.powerlaw_tail(4096, 4096 * 16, n_monster=4,
                                         seed=0))
    hyb = ops.hyb_from_csr(A)
    X = _x(A.ncols, 11)
    Y = ops.hyb_spmv(hyb.data, hyb.cols, hyb.overflow_rows,
                     hyb.overflow_cols, hyb.overflow_vals, X, device=device)
    np.testing.assert_allclose(Y.cpu()[:A.nrows], csr_matvec(A, X),
                               rtol=2e-4, atol=2e-4)
    for b in (0, 7, 8, 10):
        y1 = ops.hyb_spmv(hyb.data, hyb.cols, hyb.overflow_rows,
                          hyb.overflow_cols, hyb.overflow_vals,
                          X[:, b].copy(), device=device)
        assert torch.equal(Y[:, b], y1)


#: Pieces a lane of the carry fix-up walks alone (``csrc/spmv_seg.cu``).
LONG_ROW = int(re.search(r"constexpr int LONG_ROW = (\d+);",
                         (_lib.CSRC / "spmv_seg.cu").read_text()).group(1))


def fixup_case(ns, B, *, seed=0, S=3, R=160, C=24, L=64):
    """The carry fix-up's operands on the CPU: psum (2, B, C, L) of the
    shards sids = [2, 0] of S, each shard's row-ordered piece table
    (S, Pp, 5) and its piece_ptr (S, R+1), the out_ids and out's shape.

    Rows of every kind: none, 1, 2, LONG_ROW - 1, LONG_ROW, LONG_ROW + 1
    (either side of the long-row threshold), 31, 32, 33, 64, 65 (whole and
    cut batches of 32) and 1,037 in one split; with NS > 1 the others take
    sorted random splits.  Row 0 starts with two padded piece rows
    [0, 1, 0, 0, 0], where the per-format API's sort puts them, and each
    table is padded past its real pieces, as the executor pads it."""
    rng = np.random.default_rng(seed)
    sizes = (1, 2, LONG_ROW - 1, LONG_ROW, LONG_ROW + 1, 31, 32, 33, 64, 65,
             1037)
    pad = np.array([[0, 1, 0, 0, 0]] * 2)
    tables = []
    for _ in range(S):
        counts = rng.choice([0, 0, 0, 1, 1, 2, 3], size=R)
        counts[rng.choice(np.arange(1, R), len(sizes), replace=False)] = sizes
        recs = [pad]
        for r, c in enumerate(counts):
            split = (np.full(c, rng.integers(ns)) if c >= 1000
                     else np.sort(rng.integers(0, ns, c)))
            a, b = rng.integers(0, L, (2, c))
            lo = np.where(rng.random(c) < 0.3, 0, np.minimum(a, b))
            recs.append(np.stack([rng.integers(0, C, c), lo, np.maximum(a, b),
                                  np.full(c, r), split], 1))
        tables.append(np.concatenate(recs).astype(np.int32))
    Pp = max(len(t) for t in tables) + 5
    pieces = np.tile(np.array([0, 1, 0, 0, 0], np.int32), (S, Pp, 1))
    ptr = np.zeros((S, R + 1), np.int32)
    for s, t in enumerate(tables):
        pieces[s, :len(t)] = t
        ptr[s] = np.searchsorted(t[:, 3], np.arange(R + 1))
    psum = rng.standard_normal((2, B, C, L)).astype(np.float32)
    sids = torch.tensor([2, 0], dtype=torch.int32)
    ids = sids if ns == 1 else torch.arange(2, dtype=torch.int32)
    shape = (S, B, R) if ns == 1 else (2, B, ns, R)
    return (torch.from_numpy(psum), torch.from_numpy(pieces),
            torch.from_numpy(ptr), sids, ids, shape)


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("ns", [1, 8, 64])
def test_seg_fixup_on_card_equals_plain(device, ns, B):
    # bitwise against the plain version on CPU copies; out starts as NaN,
    # so an entry the kernel does not write shows
    psum, pcs, ptr, sids, ids, shape = fixup_case(ns, B)
    o = ids.long()
    want = spmv_seg.seg_fixup_plain(psum, pcs, ptr, sids, ids,
                                    torch.full(shape, float("nan")))[o]
    args = [t.to(device) for t in (psum, pcs, ptr, sids, ids)]

    def fixup(ps):
        return spmv_seg.seg_fixup(ps, *args[1:], num_splits=ns, out=torch.full(
            shape[:1] + (ps.shape[1],) + shape[2:], float("nan"),
            device=device))
    _lib.reset_launch_counts()
    got = fixup(args[0])
    torch.cuda.synchronize()
    assert _lib.launch_counts["seg_fixup"] == 1
    assert torch.equal(got.cpu()[o], want)
    assert torch.equal(fixup(args[0])[o], got[o])
    for b in {0, B // 2, B - 1}:
        one = fixup(args[0][:, b:b + 1].contiguous())
        assert torch.equal(one[o][:, 0], got[o][:, b])


def _bits(t):
    return t.contiguous().view(torch.int32)


def _partials_path(psum, pieces, piece_ptr, sids, num_splits, out):
    """The split family's fix-up and combine as two card launches:
    ``seg_fixup`` into (n, B, NS, R) partials, then ``split_combine``."""
    n, B = psum.shape[:2]
    part = torch.empty((n, B, num_splits, piece_ptr.shape[1] - 1),
                       device=psum.device)
    spmv_seg.seg_fixup(psum, pieces, piece_ptr, sids,
                       torch.arange(n, dtype=torch.int32, device=psum.device),
                       num_splits=num_splits, out=part)
    return spmv_split.split_combine(part, sids, out=out)


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("ns", [1, 7, 64])
def test_split_fixup_on_card_is_bitwise_the_pair(device, ns, B):
    # one launch, bitwise its plain version on CPU copies and the partials
    # path on the card; out starts as NaN, so a row it does not write
    # shows; reruns and single columns bitwise
    psum, pcs, ptr, sids = split_fixup_case(ns, B)
    o, R = sids.long(), ptr.shape[1] - 1
    want = spmv_split.split_fixup_plain(psum, pcs, ptr, sids, ns, torch.full(
        (3, B, R), float("nan")))[o]
    args = [t.to(device) for t in (psum, pcs, ptr, sids)]

    def nan_y(b):
        return torch.full((3, b, R), float("nan"), device=device)

    def fused(ps):
        return spmv_split.split_fixup(ps, *args[1:], num_splits=ns,
                                      out=nan_y(ps.shape[1]))
    _lib.reset_launch_counts()
    got = fused(args[0])
    torch.cuda.synchronize()
    assert {k: v for k, v in _lib.launch_counts.items() if v} == {
        "split_fixup": 1}
    assert torch.equal(_bits(got.cpu()[o]), _bits(want))
    assert got[1].isnan().all()
    pair = _partials_path(*args, ns, nan_y(B))
    assert torch.equal(_bits(got[o]), _bits(pair[o]))
    assert torch.equal(_bits(fused(args[0])[o]), _bits(got[o]))
    for b in {0, B // 2, B - 1}:
        one = fused(args[0][:, b:b + 1].contiguous())
        assert torch.equal(_bits(one[o][:, 0]), _bits(got[o][:, b]))


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("ns", [1, 64])
def test_split_fixup_on_long_rows_is_bitwise_the_pair(device, ns, B):
    # rows of 3 to about 4,000 pieces over 1 to 64 splits, all on the
    # warps' super-rounds: bitwise the plain version, the partials path on
    # the card and, column by column, the B = 1 call
    psum, pcs, ptr, sids = long_rows_case(B, seed=B, ns=ns)
    R = ptr.shape[1] - 1
    want = spmv_split.split_fixup_plain(psum, pcs, ptr, sids, ns, torch.full(
        (2, B, R), float("nan")))
    args = [t.to(device) for t in (psum, pcs, ptr, sids)]

    def fused(ps):
        return spmv_split.split_fixup(ps, *args[1:], num_splits=ns, out=(
            torch.full((2, ps.shape[1], R), float("nan"), device=device)))
    got = fused(args[0])
    torch.cuda.synchronize()
    assert torch.equal(_bits(got.cpu()), _bits(want))
    pair = _partials_path(*args, ns, torch.full((2, B, R), float("nan"),
                                                device=device))
    assert torch.equal(_bits(got), _bits(pair))
    for b in range(B):
        one = fused(args[0][:, b:b + 1].contiguous())
        assert torch.equal(_bits(one[:, 0]), _bits(got[:, b]))


def _tail_split_program():
    A = mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)
    return A, P.lower(A, SpmvPlan(num_shards=4, kernel="split"))


@pytest.mark.parametrize("B", [1, 8])
def test_split_fixup_on_powerlaw_tail_is_bitwise_the_pair(device, B):
    # the executor's own tables and psum, both passes (NS 1 and 64)
    A, prog = _tail_split_program()
    run = P.make_program_spmv_fn(prog, device=device)
    T, sids = run.operands, run.families["split"]
    s, R = sids.long(), run.rows_out
    x = torch.from_numpy(prog.x_to_device(_x(A.ncols, B))).to(device)
    for pre, xbuf in zip(("loc_", "rem_"), run.buffers(x)):
        ns = run.num_splits[pre]
        psum = spmv_seg.seg_psum(T[pre + "seg_vals"], T[pre + "seg_cols"],
                                 xbuf, sids)
        a = (psum, T[pre + "seg_pieces"], T[pre + "piece_ptr"], sids)
        got = spmv_split.split_fixup(*a, num_splits=ns, out=torch.full(
            (len(s), B, R), float("nan"), device=device))
        want = _partials_path(*a, ns, torch.full((len(s), B, R),
                                                 float("nan"), device=device))
        assert not got[s].isnan().any()
        assert torch.equal(_bits(got[s]), _bits(want[s]))
    assert run.num_splits["rem_"] > 1


@pytest.mark.parametrize("B", [1, 8])
def test_graphed_split_executor_is_bitwise_the_partials_path(device,
                                                             monkeypatch, B):
    # graph replays of the fused path against the eager executor run
    # through seg_fixup into partials and split_combine, three x each
    A, prog = _tail_split_program()
    graphed = P.make_program_spmv_fn(prog, device=device, graphs=True)
    rng = np.random.default_rng(11)
    shape = (A.ncols,) if B == 1 else (A.ncols, B)
    xs = [_on_card(prog, rng.standard_normal(shape), device)
          for _ in range(3)]
    got = [graphed(x).clone() for x in xs]
    monkeypatch.setattr(ops, "_split_fixup_combine", _partials_path)
    eager = P.make_program_spmv_fn(prog, device=device)
    _lib.reset_launch_counts()
    want = [eager(x) for x in xs]
    torch.cuda.synchronize()
    assert _lib.launch_counts["split_combine"] == 2 * len(xs)
    assert _lib.launch_counts["split_fixup"] == 0
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("L", [32, 128, 512, 1024])
def test_seg_psum_on_card(device, L):
    # two shards (the second a sign-flipped copy) read in reverse order,
    # per-shard and shared x; B = 11 spans two chunks of 8 columns
    A = mats.powerlaw_tail(4096, 4096 * 8, n_monster=2, seed=0)
    seg = ops.seg_from_csr(A, chunk=L, lane=32)
    assert seg.vals.shape[1] == L
    vals = torch.from_numpy(np.stack([seg.vals, -seg.vals])).to(device)
    cols = torch.from_numpy(np.stack([seg.cols, seg.cols])).to(device)
    sids = torch.tensor([1, 0], dtype=torch.int32, device=device)
    for Sx in (2, 1):
        x = torch.from_numpy(np.stack([_x(A.ncols, 11)] * Sx)).to(device)
        _card_and_plain(spmv_seg.seg_psum, spmv_seg.seg_psum_plain,
                        (vals, cols, x, sids),
                        (vals.abs(), cols, x.abs(), sids))

        def psum(v):
            return spmv_seg.seg_psum(vals, cols, v, sids)
        _columns_match_single(psum, x, 1)
        assert torch.equal(psum(x), psum(x))


#: Small matrices under the benchmark's seg plans: banded (halo, none)
#: and rmat (random reordering, nonzero split).
SEG_PROGRAMS = {
    "banded": lambda: (mats.banded(4096, 4096 * 24, 400, seed=0),
                       SpmvPlan(num_shards=4, kernel="seg")),
    "rmat": lambda: (mats.rmat(4096, 4096 * 8, seed=0),
                     SpmvPlan(num_shards=4, kernel="seg", reordering="random",
                              distribution="nonzero")),
}


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("name", sorted(SEG_PROGRAMS))
def test_seg_piece_sums_equal_the_two_kernel_path(device, name, B):
    # the executor's own tables, both passes: seg_stacked (seg_piece_sums,
    # then the fix-up over d) against seg_psum then seg_fixup, bitwise;
    # B = 11 spans two chunks of 8 columns
    A, plan = SEG_PROGRAMS[name]()
    prog = P.lower(A, plan)
    run = P.make_program_spmv_fn(prog, device=device)
    T, sids = run.operands, run.families["seg"]
    s = sids.long()
    x = prog.x_to_device(_x(A.ncols, B))
    for pre, xbuf in zip(("loc_", "rem_"),
                         run.buffers(torch.from_numpy(x).to(device))):
        a = [T[pre + k] for k in ("seg_vals", "seg_cols", "seg_pieces",
                                  "piece_ptr")]
        shape = (len(s), B, a[3].shape[1] - 1)
        _lib.reset_launch_counts()
        got = ops.seg_stacked(*a, xbuf, sids,
                              chunk_ptr=T[pre + "seg_chunk_ptr"],
                              out=torch.full(shape, float("nan"),
                                             device=device))
        torch.cuda.synchronize()
        assert {k: v for k, v in _lib.launch_counts.items() if v} == {
            "seg_piece_sums": 1, "seg_fixup": 1}
        psum = spmv_seg.seg_psum(a[0], a[1], xbuf, sids)
        want = spmv_seg.seg_fixup(psum, *a[2:], sids, sids, num_splits=1,
                                  out=torch.full(shape, float("nan"),
                                                 device=device))
        assert torch.equal(got[s], want[s])
        assert not got[s].isnan().any()
        built = ops.seg_stacked(*a, xbuf, sids, out=torch.full(
            shape, float("nan"), device=device))
        assert torch.equal(built[s], got[s])
        _columns_match_single(
            lambda v: ops.seg_stacked(*a, v, sids,
                                      chunk_ptr=T[pre + "seg_chunk_ptr"]),
            xbuf, 1)


@pytest.mark.parametrize("B,aligned", [(8, True), (3, True), (8, False)])
def test_seg_scans_read_x_rows_on_card(device, B, aligned):
    # the banded program's remote pass: at B = 8 x's rows take 16-byte
    # loads, at B = 3, or from an x 4 bytes off 16, 4-byte ones.  seg_psum
    # within 1e-5 of its plain version; seg_piece_sums' d bitwise seg_psum's
    # difference at each real piece; each column of both bitwise the
    # one-column launch, which reads x as the batch-major kernels did
    A, plan = SEG_PROGRAMS["banded"]()
    prog = P.lower(A, plan)
    run = P.make_program_spmv_fn(prog, device=device)
    T, sids = run.operands, run.families["seg"]
    _, xg = run.buffers(torch.from_numpy(prog.x_to_device(
        _x(A.ncols, B))).to(device))
    if not aligned:
        moved = torch.empty(xg.numel() + 1, device=device)[1:].view(xg.shape)
        moved.copy_(xg)
        assert moved.data_ptr() % 16
        xg = moved
    vals, cols, pcs, cptr = (T["rem_" + k] for k in (
        "seg_vals", "seg_cols", "seg_pieces", "seg_chunk_ptr"))
    _card_and_plain(spmv_seg.seg_psum, spmv_seg.seg_psum_plain,
                    (vals, cols, xg, sids), (vals.abs(), cols, xg.abs(), sids))

    def psum(v):
        return spmv_seg.seg_psum(vals, cols, v, sids)

    def diffs(v):
        out = torch.zeros((len(sids), v.shape[2], pcs.shape[1]),
                          device=device)
        return spmv_seg.seg_piece_sums(vals, cols, v, pcs, cptr, sids,
                                       out=out)
    _columns_match_single(psum, xg, 1)
    _columns_match_single(diffs, xg, 1)
    ps, d = psum(xg), diffs(xg)
    C = vals.shape[1]
    for k, sid in enumerate(sids.tolist()):
        p0, p1 = int(cptr[sid, 0]), int(cptr[sid, C])
        chunk, lo, hi = pcs[sid, p0:p1, :3].long().unbind(1)
        h = ps[k][:, chunk, hi]
        want = torch.where(lo > 0, h - ps[k][:, chunk, (lo - 1).clamp(min=0)],
                           h)
        real = lo <= hi
        assert torch.equal(d[k][:, p0:p1][:, real], want[:, real])


def test_batch_minor_buffers_on_card(device):
    # the executor's local buffer is the caller's (S, per, 8) x itself, no
    # copy; the exchange's is (Sx, Lx, 8); the graphed B = 8 call is
    # bitwise the eager call, each column bitwise the B = 1 call
    A, plan = SEG_PROGRAMS["banded"]()
    prog = P.lower(A, plan)
    eager = P.make_program_spmv_fn(prog, device=device)
    graphed = P.make_program_spmv_fn(prog, device=device, graphs=True)
    xs = torch.from_numpy(prog.x_to_device(_x(A.ncols, 8))).to(device)
    xb, xg = eager.buffers(xs)
    assert xb.data_ptr() == xs.data_ptr() and xb.shape == xs.shape
    assert xg.shape[2] == 8 and xg.is_contiguous()
    y = eager(xs)
    assert torch.equal(graphed(xs), y)
    assert torch.equal(graphed(xs.clone()), y)
    for b in range(8):
        assert torch.equal(y[..., b], eager(xs[..., b].contiguous()))


@pytest.mark.parametrize("B,aligned", [(1, True), (3, True), (8, True),
                                       (16, True), (8, False)])
def test_gather_rows_on_card(device, B, aligned):
    # the exchange's row gather: bitwise advanced indexing, a 2-D index
    # with repeats; 16-byte rows at B % 4 == 0 from aligned buffers, else
    # 4-byte ones (B = 3, or x 4 bytes off 16)
    x = torch.from_numpy(_x(5000, B)).to(device)
    if not aligned:
        moved = torch.empty(x.numel() + 1, device=device)[1:].view(x.shape)
        moved.copy_(x)
        assert moved.data_ptr() % 16
        x = moved
    g = torch.Generator().manual_seed(B)
    index = torch.randint(0, 5000, (3, 7001), generator=g).to(device)
    _lib.reset_launch_counts()
    got = exchange.gather_rows(x, index)
    torch.cuda.synchronize()
    assert _lib.launch_counts["gather_rows"] == 1
    assert got.shape == (3, 7001, B)
    assert torch.equal(got, x[index])


@pytest.mark.parametrize("kernels", ["seg", "split", "seg+split"])
def test_each_family_launches_its_own_kernels(device, kernels):
    # the seg family: seg_piece_sums and the fix-up, never seg_psum; the
    # split family: seg_psum and the fused fix-up and combine, one launch
    # a pass, never the partials path (seg_fixup's NS outputs and
    # split_combine); the exchange's row gather, gather_rows
    A = mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)
    fams = kernels.split("+")
    prog = P.lower(A, SpmvPlan(num_shards=4, shard_kernels=tuple(
        fams[i % len(fams)] for i in range(4))))
    _lib.reset_launch_counts()
    fn = P.make_program_spmv_fn(prog, device=device)
    y = fn(torch.from_numpy(prog.x_to_device(_x(A.ncols, 1)[:, 0]))
           .to(device))
    torch.cuda.synchronize()
    launched = {k for k, v in _lib.launch_counts.items() if v}
    want = {"gather_rows"}                      # the exchange
    if "seg" in fams:
        want |= {"seg_piece_sums", "seg_fixup"}
    if "split" in fams:
        want |= {"seg_psum", "split_fixup"}
        assert _lib.launch_counts["split_fixup"] == 2
    assert launched == want
    np.testing.assert_allclose(
        P.gather_b(prog, y), csr_matvec(A, _x(A.ncols, 1)[:, 0]),
        rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# chunks over 1024 and tile shapes other than (8k, 128)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("L", [2048, 4096])
def test_long_chunk_psums_on_card(device, L, B):
    # seg_psum on two shards read in reverse order; split_psum (NS = 3) is
    # seg_psum's scan on the flattened (1, NS*Cs, L) slab, bitwise; B = 11
    # spans two chunks of 8 columns
    A = mats.powerlaw_tail(4096, 4096 * 8, n_monster=2, seed=0)
    seg = ops.seg_from_csr(A, chunk=L)
    assert seg.vals.shape[1] == L
    vals = torch.from_numpy(np.stack([seg.vals, -seg.vals])).to(device)
    cols = torch.from_numpy(np.stack([seg.cols, seg.cols])).to(device)
    sids = torch.tensor([1, 0], dtype=torch.int32, device=device)
    x = torch.from_numpy(np.stack([_x(A.ncols, B)] * 2)).to(device)
    _card_and_plain(spmv_seg.seg_psum, spmv_seg.seg_psum_plain,
                    (vals, cols, x, sids), (vals.abs(), cols, x.abs(), sids))
    _columns_match_single(lambda v: spmv_seg.seg_psum(vals, cols, v, sids),
                          x, 1)
    spl = ops.split_from_csr(A, 3, chunk=L)
    NS, Cs, _ = spl.vals.shape
    sv, sc = (torch.from_numpy(a).to(device) for a in (spl.vals, spl.cols))
    xb = torch.from_numpy(_x(A.ncols, B)).to(device)
    _card_and_plain(spmv_split.split_psum, spmv_split.split_psum_plain,
                    (sv, sc, xb), (sv.abs(), sc, xb.abs()))
    flat = spmv_seg.seg_psum(sv.view(1, NS * Cs, L), sc.view(1, NS * Cs, L),
                             xb[None], torch.zeros(1, dtype=torch.int32,
                                                   device=device))
    got = spmv_split.split_psum(sv, sc, xb)
    assert torch.equal(got.view(flat.shape), flat)
    _columns_match_single(lambda v: spmv_split.split_psum(sv, sc, v), xb, 0)


@pytest.mark.parametrize("chunk", [2048, 4096])
def test_long_chunk_ops_on_card(device, chunk):
    # the per-format ops that raised on the card at chunks over 1024
    A = mats.powerlaw(1024, 8000, seed=5)
    X = _x(A.ncols, 3)
    seg = ops.seg_from_csr(A, chunk=chunk)
    spl = ops.split_from_csr(A, 2, chunk=chunk)
    ns, Cs, L = spl.vals.shape
    pieces = np.stack([spl.piece_split * Cs + spl.piece_chunk, spl.piece_lo,
                       spl.piece_hi, spl.piece_row, spl.piece_split], 1)
    flat = [a.reshape(ns * Cs, L) for a in (spl.vals, spl.cols, spl.rows)]
    for run in (lambda v: ops.seg_spmv(seg, v, device=device),
                lambda v: ops.split_spmv(spl, v, device=device),
                lambda v: ops.split_flat_spmv(*flat, pieces, v,
                                              num_rows=A.nrows,
                                              num_splits=ns, device=device)):
        Y = run(X)
        np.testing.assert_allclose(Y.cpu(), csr_matvec(A, X), rtol=2e-4,
                                   atol=2e-4)
        for b in range(3):
            assert torch.equal(Y[:, b], run(X[:, b].copy()))


#: Tile shapes the fast walks do not all take: (16, 128) is the mask walk's
#: fast path and tile_contrib's general one; bm = 5 leaves row slots of a
#: warp empty, bn = 40 lanes of a row (and reads the mask a byte at a time);
#: (16, 16) and (32, 32) are the kernel_api phase's general shapes.
SHAPES = [(8, 256), (16, 64), (4, 128), (8, 64), (16, 128), (12, 40),
          (5, 40), (16, 16), (32, 32)]


def flat_tile_case(t, n, B, *, shared_x=False, seed=0):
    """``tile_contrib``'s flat operands (S = 4) of a TileMatrix ``t`` over
    n columns, on the CPU, as the executor stacks them: shard 0 holds t's
    tiles, shard 1 none, shard 2 those of t's first half of block rows,
    shard 3 (not listed) its last tile; padding tiles past each shard's
    real ones hold NaN at block row Rb = Mb + 3, so ``rb_used`` < Rb.  A
    lane of zero cells reads x position 0, the others x at the tile's
    block column, clamped below n.  Returns data, xcol, brow, tile_ptr,
    x ((1 or 4), n, B), sids = [2, 1, 0], rb_used and Rb."""
    T, bm, bn = t.data.shape
    Mb = len(t.tile_ptr) - 1
    Rb = Mb + 3
    spans = [(0, T), (0, 0), (0, int(t.tile_ptr[Mb // 2])), (T - 1, T)]
    Tp = T + 4
    data = np.full((4, Tp, bm, bn), np.nan, np.float32)
    xcol = np.zeros((4, Tp, bn), np.int32)
    brow = np.full((4, Tp), Rb, np.int32)
    lanes = np.minimum(t.tile_cols[:, None].astype(np.int64) * bn
                       + np.arange(bn), n - 1)
    lanes = np.where((t.data != 0).any(axis=1), lanes, 0)
    for s, (a, b) in enumerate(spans):
        data[s, :b - a], xcol[s, :b - a] = t.data[a:b], lanes[a:b]
        brow[s, :b - a] = t.tile_rows[a:b]
    tile_ptr = np.stack([np.searchsorted(b, np.arange(Rb + 1))
                         for b in brow]).astype(np.int32)
    rb_used = int(t.tile_rows.max()) + 1
    x = np.random.default_rng(seed).standard_normal(
        (1 if shared_x else 4, B, n)).astype(np.float32)
    x = np.ascontiguousarray(x.transpose(0, 2, 1))              # batch-minor
    return ([torch.from_numpy(a) for a in (data, xcol, brow, tile_ptr, x)]
            + [torch.tensor([2, 1, 0], dtype=torch.int32), rb_used, Rb])


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("bm,bn", SHAPES)
def test_tile_walks_at_any_shape_on_card(device, bm, bn, B):
    # the masked walk and the null-mask walk against their plain version,
    # with stored zeros, block rows without tiles and a cut last x block;
    # then tile_spmv against csr_matvec
    A = _stored_zeros(_cut_tail())
    t = ops.tile_from_csr(A, bm=bm, bn=bn)
    assert (np.diff(t.tile_ptr) == 0).any()
    data, tcols, tptr, mask = (torch.from_numpy(a).to(device) for a in (
        t.data, t.tile_cols, t.tile_ptr, t.mask))
    xb = torch.from_numpy(_x(A.ncols, B)).to(device)
    for m in (mask, None):
        def walk(v, m=m):
            return spmv_tile.tile_walk_spmv(data, tcols, tptr, v, mask=m)
        _card_and_plain(lambda *a: walk(a[3]), spmv_tile.tile_walk_spmv_plain,
                        (data, tcols, tptr, xb),
                        (data.abs(), tcols, tptr, xb.abs()))
        _columns_match_single(walk, xb, 0)
    X = _x(A.ncols, B)
    Y = ops.tile_spmv(t, X, device=device)
    np.testing.assert_allclose(Y.cpu(), csr_matvec(A, X), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("bm,bn", SHAPES)
def test_tile_contrib_at_any_shape_on_card(device, bm, bn, B, shared_x):
    # padding tiles (NaN, never read), a shard with no tiles, rb_used < Rb
    # (rows from rb_used * bm zeroed by 4-byte stores, odd bm too); out
    # starts as NaN, and shard 3 is not listed
    A = _stored_zeros(_cut_tail())
    t = ops.tile_from_csr(A, bm=bm, bn=bn)
    data, xcol, brow, tile_ptr, x, sids, rb_used, Rb = flat_tile_case(
        t, A.ncols, B, shared_x=shared_x)
    args = [v.to(device) for v in (data, xcol, brow, tile_ptr)]
    xd, sd, rows = x.to(device), sids.to(device), sids.long()

    def contrib(v, rb=rb_used):
        out = torch.full((4, v.shape[2], Rb * bm), float("nan"),
                         device=device)
        return spmv_tile.tile_contrib(*args, v, sd, rb_used=rb, out=out)
    _lib.reset_launch_counts()
    got = contrib(xd).cpu()
    assert _lib.launch_counts["tile_contrib"] == 1
    want = spmv_tile.tile_contrib_plain(data, xcol, brow, x, sids,
                                        torch.zeros(got.shape))
    scale = spmv_tile.tile_contrib_plain(data.abs(), xcol, brow, x.abs(),
                                         sids, torch.zeros(got.shape))
    assert bool((got[rows] - want[rows]).abs().le(
        1e-5 * (1.0 + scale[rows])).all())
    assert not got[rows, :, rb_used * bm:].any()
    assert got[3].isnan().all()
    _columns_match_single(lambda v: contrib(v)[rows], xd, 1)
    assert torch.equal(contrib(xd, None).cpu()[rows], got[rows])


@pytest.mark.parametrize("bm,bn", SHAPES)
def test_tile_flat_spmv_at_any_shape_on_card(device, bm, bn):
    A = _stored_zeros(_cut_tail())
    t = ops.tile_from_csr(A, bm=bm, bn=bn)
    xcols = np.minimum(t.tile_cols[:, None].astype(np.int64) * bn
                       + np.arange(bn), A.ncols - 1)
    X = _x(A.ncols, 3)

    def run(v):
        return ops.tile_flat_spmv(t.data, xcols, t.tile_rows, v,
                                  num_rows=A.nrows, device=device)
    Y = run(X)
    np.testing.assert_allclose(Y.cpu(), csr_matvec(A, X), rtol=2e-4,
                               atol=2e-4)
    for b in range(3):
        assert torch.equal(Y[:, b], run(X[:, b].copy()))


@pytest.mark.parametrize("bm,bn", [(5, 10), (16, 6), (3, 1)])
def test_tile_flat_spmv_at_odd_widths_on_card(device, bm, bn):
    # tile_contrib's general walk one cell a load (bn % 4 != 0), on the
    # csr_to_bcsr blocks as flat tiles
    A = _stored_zeros(_cut_tail())
    b = csr_to_bcsr(A, (bm, bn))
    xcols = np.minimum(b.block_cols[:, None].astype(np.int64) * bn
                       + np.arange(bn), A.ncols - 1)
    trows = np.repeat(np.arange(len(b.block_row_ptr) - 1),
                      np.diff(b.block_row_ptr))
    X = _x(A.ncols, 11)

    def run(v):
        return ops.tile_flat_spmv(b.blocks, xcols, trows, v,
                                  num_rows=A.nrows, device=device)
    Y = run(X)
    np.testing.assert_allclose(Y.cpu(), csr_matvec(A, X), rtol=2e-4,
                               atol=2e-4)
    for c in (0, 7, 8, 10):
        assert torch.equal(Y[:, c], run(X[:, c].copy()))


def _plan_matrix(name):
    return mats.blocked_band(4096, 4096 * 24, seed=0) if name == "mixed" \
        else mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)


def _on_card(prog, x, device):
    xp = x if prog.perm is None else P._apply_perm(x, prog.perm)
    return torch.from_numpy(prog.x_to_device(xp.astype(np.float32))).to(
        device)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_graph_replay_equals_eager(device, name):
    """Graph-replayed calls are bitwise the eager executor's, a vector
    and an (N, 8) block, new x every call; launches count at the capture
    (and its warm-up call), not at replays."""
    A = _plan_matrix(name)
    prog = P.lower(A, SpmvPlan(**PLANS[name]))
    eager = P.make_program_spmv_fn(prog, device=device)
    graphed = P.make_program_spmv_fn(prog, device=device, graphs=True)
    rng = np.random.default_rng(7)
    for shape in ((A.ncols,), (A.ncols, 8)):
        for i in range(3):
            xs = _on_card(prog, rng.standard_normal(shape), device)
            _lib.reset_launch_counts()
            got = graphed(xs if i else xs.cpu().numpy())
            counted = sum(_lib.launch_counts.values())
            assert (counted > 0) == (i == 0)
            assert torch.equal(got, eager(xs))
    stats = graphed.graph_stats()
    S, per = prog.plan.num_shards, prog.x_layout.padded_length() // \
        prog.plan.num_shards
    assert [st["shape"] for st in stats] == [[S, per], [S, per, 8]]
    assert all(st["replays"] == 3 and st["bytes"] > 0 for st in stats)
    y = P.device_spmv(graphed, np.ones(A.ncols))
    np.testing.assert_allclose(y, csr_matvec(A, np.ones(A.ncols)),
                               rtol=2e-4, atol=2e-4)


def test_powerlaw_tail_plan_replays_bitwise_and_counts_split_scratch(
        device):
    """The benchmark's powerlaw_tail plan (split on the four shards with
    the dense rows, seg on the rest) at 65,536 rows: graph replays are
    bitwise the eager calls, a vector and an (N, 8) block, and each
    recorded replay counts the split family's scratch as the eager call
    does."""
    from repro_torch import tracing
    conf = json.loads((Path(__file__).resolve().parents[1] / "bench" /
                       "configs" / "powerlaw_tail.json").read_text())
    M, n_monster = 1 << 16, conf["matrix"]["n_monster"]
    A = mats.powerlaw_tail(M, 2 * n_monster * M, n_monster=n_monster,
                           seed=0)
    prog = P.lower(A, SpmvPlan(**conf["plan"]))
    assert prog.shard_kernels() == tuple(conf["plan"]["shard_kernels"])
    eager = P.make_program_spmv_fn(prog, device=device)
    graphed = P.make_program_spmv_fn(prog, device=device, graphs=True)
    rng = np.random.default_rng(3)
    try:
        for shape in ((M,), (M, 8)):
            xs = [_on_card(prog, rng.standard_normal(shape), device)
                  for _ in range(3)]
            graphed(xs[0])                        # the capture
            tracing.reset()
            tracing.enable()
            want = [eager(x) for x in xs]
            torch.cuda.synchronize(device)
            per_call = tracing.counter("split.scratch_bytes") // 3
            assert per_call > 0
            tracing.reset()                       # a new session
            tracing.enable()
            got = [graphed(x) for x in xs]
            torch.cuda.synchronize(device)
            assert tracing.counter("spmv.calls") == 3
            assert tracing.counter("split.scratch_bytes") == 3 * per_call
            tracing.reset()
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    finally:
        tracing.reset()
    x = rng.standard_normal(M)
    y = P.device_spmv(graphed, x).astype(np.float64)
    xf = x.astype(np.float32).astype(np.float64)
    scale = np.abs(csr_matvec(dataclasses.replace(
        A, values=np.abs(A.values)), np.abs(xf))).max()
    err = np.abs(y - csr_matvec(A, xf)).max() / scale
    assert err <= conf["limit"]["norm_err"]


def test_blocked_band_plan_replays_bitwise_and_matches_float64(device):
    """The benchmark's blocked_band plan (tile on the four band shards,
    ELL on the four scattered ones) at its rehearsal size, 4,096 rows:
    graph replays are bitwise the eager calls, a vector and an (N, 8)
    block, each recorded replay counts the tile and ELL families as the
    eager call does, and y is the float64 product's within the
    configuration's limit."""
    from repro_torch import tracing
    conf = json.loads((Path(__file__).resolve().parents[1] / "bench" /
                       "configs" / "blocked_band.json").read_text())
    params = {k: v for k, v in conf["matrix"].items()
              if k not in ("generator", "M", "nnz")}
    M, nnz = conf["matrix"]["M"] // 64, conf["matrix"]["nnz"] // 64
    A = mats.blocked_band(M, nnz, seed=0, **params)
    prog = P.lower(A, SpmvPlan(**conf["plan"]))
    assert prog.shard_kernels() == tuple(conf["plan"]["shard_kernels"])
    eager = P.make_program_spmv_fn(prog, device=device)
    graphed = P.make_program_spmv_fn(prog, device=device, graphs=True)
    rng = np.random.default_rng(3)
    names = ("tile.nnz", "tile.tiles", "ell.nnz", "ell.x_elems")
    try:
        for shape in ((M,), (M, 8)):
            xs = [_on_card(prog, rng.standard_normal(shape), device)
                  for _ in range(3)]
            graphed(xs[0])                        # the capture
            tracing.reset()
            tracing.enable()
            want = [eager(x) for x in xs]
            torch.cuda.synchronize(device)
            per_call = {k: tracing.counter(k) // 3 for k in names}
            assert all(per_call.values())
            tracing.reset()                       # a new session
            tracing.enable()
            got = [graphed(x) for x in xs]
            torch.cuda.synchronize(device)
            assert tracing.counter("spmv.calls") == 3
            assert {k: tracing.counter(k) for k in names} == \
                {k: 3 * v for k, v in per_call.items()}
            tracing.reset()
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    finally:
        tracing.reset()
    for shape in ((M,), (M, 8)):
        x = rng.standard_normal(shape)
        y = P.device_spmv(graphed, x).astype(np.float64).reshape(M, -1)
        xf = x.astype(np.float32).astype(np.float64).reshape(M, -1)
        absA = dataclasses.replace(A, values=np.abs(A.values))
        for c in range(xf.shape[1]):
            scale = np.abs(csr_matvec(absA, np.abs(xf[:, c]))).max()
            err = np.abs(y[:, c] - csr_matvec(A, xf[:, c])).max() / scale
            assert err <= conf["limit"]["norm_err"]


@pytest.mark.parametrize("graphs", [True, False])
def test_call_spans_and_starvation_on_the_card(device, graphs):
    """With recording on, every call adds to ``spmv.call`` and
    ``spmv.calls``; a call made after the device has drained counts as
    starved, and one made behind a queue of unfinished calls does not.
    The capture's span is ``graph_stats()``'s ``capture_s``."""
    from repro_torch import tracing
    A = _plan_matrix("split")
    prog = P.lower(A, SpmvPlan(**PLANS["split"]))
    run = P.make_program_spmv_fn(prog, device=device, graphs=graphs)
    xs = _on_card(prog, np.ones(A.ncols), device)
    run(xs)
    if graphs:
        assert run.graph_stats()[0]["capture_s"] == \
            tracing.last("executor.capture").seconds
    tracing.enable()
    try:
        torch.cuda.synchronize(device)
        run(xs)                                   # the device had drained
        assert tracing.counter("spmv.starved") == 1
        torch.cuda._sleep(200_000_000)            # keep the queue busy
        for _ in range(8):                        # only the first of these
            run(xs)                               # may see the call before
        assert tracing.counter("spmv.starved") <= 2
        starved = tracing.counter("spmv.starved")
        torch.cuda.synchronize(device)
        run(xs)
        assert tracing.counter("spmv.starved") == starved + 1
        calls, seconds = tracing.total("spmv.call")
        assert calls == tracing.counter("spmv.calls") == 10 and seconds > 0
    finally:
        tracing.disable()
    torch.cuda.synchronize(device)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_mesh_executor_on_nccl_equals_one_device(device, name, tmp_path):
    """The executor over a world-size-1 NCCL mesh (the exchange and the y
    gather as collectives of a group of one) is bitwise the one-device
    executor, a vector and an (N, 3) block, pipelined or not."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import build_mesh, world_devices
    A = _plan_matrix(name)
    prog = P.lower(A, SpmvPlan(**PLANS[name]))
    rng = np.random.default_rng(11)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = build_mesh(("model",), (1,), world_devices(device))
        for pipeline in (True, False):
            one = P.make_program_spmv_fn(prog, device=device,
                                         pipeline=pipeline)
            run = P.make_program_spmv_fn(prog, mesh, pipeline=pipeline)
            for shape in ((A.ncols,), (A.ncols, 3)):
                x = rng.standard_normal(shape)
                xs = _on_card(prog, x, device)
                assert torch.equal(run(xs), one(xs))
                np.testing.assert_array_equal(
                    P.execute(prog, x, backend="shard_map", mesh=mesh,
                              pipeline=pipeline),
                    P.device_spmv(one, x))
    finally:
        dist.destroy_process_group()


def test_graph_replay_serves_each_thread_its_answer(device):
    """Two threads replaying one executor (with a short switch interval)
    each get the answers to their own x."""
    import sys
    import threading

    A = _plan_matrix("mixed")
    prog = P.lower(A, SpmvPlan(**PLANS["mixed"]))
    eager = P.make_program_spmv_fn(prog, device=device)
    graphed = P.make_program_spmv_fn(prog, device=device, graphs=True)
    rng = np.random.default_rng(8)
    xs = [_on_card(prog, rng.standard_normal(A.ncols), device)
          for _ in range(2 * 24)]
    want = [eager(x) for x in xs]
    got = [None] * len(xs)

    def client(t):
        for i in range(t, len(xs), 2):
            got[i] = graphed(xs[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_router_on_card(device):
    """The router on the card: answers within the scaled 2e-4,
    micro-batched answers bitwise the solo calls and the eager executor,
    and a rebalance swap serves the new program through a fresh
    executor."""
    import threading

    from repro_torch.serve import MicroBatchConfig, RebalanceConfig, \
        SparseMatrixEngine

    def scaled(A, x, y):
        absA = dataclasses.replace(A, values=np.abs(A.values))
        return float((np.abs(y - csr_matvec(A, x))
                      / (1.0 + csr_matvec(absA, np.abs(x)))).max())

    A = mats.make_matrix("cop20k_A", scale=0.005)
    eng = SparseMatrixEngine(num_shards=4, device=device,
                             micro_batch=MicroBatchConfig(max_batch=4,
                                                          max_wait_ms=50.0))
    eng.ingest("a", A)
    m = eng._matrices["a"]
    assert len(m.executor.graph_stats()) == 4        # shapes B = 1..4
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal(A.ncols) for _ in range(4)]
    got = [None] * 4
    barrier = threading.Barrier(4)

    def hit(i):
        barrier.wait(timeout=30)
        got[i] = eng.spmv("a", xs[i])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert eng.stats()["a"]["micro_batch"]["widest"] >= 2
    eager = P.make_program_spmv_fn(m.dist, device=device)
    for x, y in zip(xs, got):
        assert scaled(A, x, y) <= 2e-4
        assert np.array_equal(y, eng.spmv("a", x))
        assert np.array_equal(y, P.device_spmv(eager, x))

    cfg = RebalanceConfig(window=32, patience=2, cooldown=2, probe=2)
    eng = SparseMatrixEngine(num_shards=4, rebalance=cfg, device=device)
    eng.ingest("a", A)
    m = eng._matrices["a"]
    first = m.executor
    order = np.arange(A.ncols) if m.dist.perm is None else m.dist.perm
    hot = np.flatnonzero(m.dist.x_layout.owner_of(order) == 0)
    k = max(A.ncols // 20, 8)
    for i in range(12 * cfg.window):
        x = np.zeros(A.ncols)
        idx = rng.integers(0, A.ncols, k) if i < 2 * cfg.window \
            else rng.choice(hot, size=k)
        x[idx] = rng.standard_normal(k)
        assert scaled(A, x, eng.spmv("a", x)) <= 2e-4
        if any(e.swapped for e in m.rebalance_log):
            break
    assert any(e.swapped for e in m.rebalance_log)
    assert m.executor is not first and m.executor.program is m.dist
    assert [st["shape"] for st in m.executor.graph_stats()] == \
        [st["shape"] for st in first.graph_stats()]
    assert not any(t.data_ptr() == u.data_ptr()
                   for t in m.executor.operands.values()
                   for u in first.operands.values() if t.numel())
    x = np.random.default_rng(10).standard_normal(A.ncols)
    assert scaled(A, x, eng.spmv("a", x)) <= 2e-4


def test_router_async_replan_captures_beside_requests(device):
    """``async_replan``: the re-plan thread builds the new program's
    executor and captures its shapes while this thread keeps serving
    through the old one (thread-local capture); every answer is within
    the scaled 2e-4 and the swapped-in executor serves the new program."""
    from repro_torch.serve import RebalanceConfig, SparseMatrixEngine

    A = mats.make_matrix("cop20k_A", scale=0.005)
    absA = dataclasses.replace(A, values=np.abs(A.values))
    cfg = RebalanceConfig(window=32, patience=2, cooldown=2, probe=2,
                          async_replan=True)
    eng = SparseMatrixEngine(num_shards=4, rebalance=cfg, device=device)
    eng.ingest("a", A)
    m = eng._matrices["a"]
    first = m.executor
    order = np.arange(A.ncols) if m.dist.perm is None else m.dist.perm
    hot = np.flatnonzero(m.dist.x_layout.owner_of(order) == 0)
    rng = np.random.default_rng(11)
    k = max(A.ncols // 20, 8)
    during = 0
    for i in range(40 * cfg.window):
        x = np.zeros(A.ncols)
        idx = rng.integers(0, A.ncols, k) if i < 2 * cfg.window \
            else rng.choice(hot, size=k)
        x[idx] = rng.standard_normal(k)
        y = eng.spmv("a", x)
        err = np.abs(y - csr_matvec(A, x)) / (1.0 + csr_matvec(absA,
                                                               np.abs(x)))
        assert err.max() <= 2e-4
        worker = m.replan_thread
        if worker is not None:
            during += worker.is_alive()
            if not worker.is_alive() and any(e.swapped
                                             for e in m.rebalance_log):
                break
    assert m.replan_thread is not None
    m.replan_thread.join(timeout=120)
    assert not m.replan_thread.is_alive()
    assert during > 0                        # served while it re-planned
    assert any(e.swapped for e in m.rebalance_log)
    assert m.executor is not first and m.executor.program is m.dist
    assert m.executor.graph_stats()
