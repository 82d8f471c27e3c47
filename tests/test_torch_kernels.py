"""Each kernel module's plain PyTorch version against the JAX reference.

The port's wrappers run their kernels' plain versions here, because the
tensors lie on the CPU.  Each is held to the Pallas kernel run with
``interpret=True`` and to the jnp oracle in ``repro.kernels.ref``, on the
executor's own S-stacked operands (so the traps are the real ones: padded
ELL slots, the HYB overflow with its unsorted stacking padding, rows
spanning many chunks, the monster-row carry, padded piece rows
``[0, 1, 0, 0, 0]``, padding tiles with block row ``Rb``, empty matrices)
and batched against per-vector.  Tolerance 1e-5, scaled by |A|·|x|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.program as r_program
import repro.data.matrices as r_mat
import repro.kernels.ops as r_ops
import repro.kernels.ref as r_ref
from repro.core.spmv import SpmvPlan as RPlan
from repro.kernels.spmv_ell import ell_spmv as r_ell_pallas
from repro.kernels.spmv_seg import seg_psum as r_seg_psum_pallas
from repro.kernels.spmv_split import split_combine as r_combine_pallas
from repro.kernels.spmv_tile import tile_contrib as r_tile_contrib_pallas

import repro_torch.core.program as t_program
from repro_torch.core.sparse_matrix import CSRMatrix
from repro_torch.core.spmv import SpmvPlan as TPlan
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import spmv_seg, spmv_split

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-5


def _port(A):
    return CSRMatrix(shape=A.shape, values=A.values, col_index=A.col_index,
                     row_ptr=A.row_ptr)


def _setup(A, S, **fields):
    """Both programs, the port's CPU executor and its x buffers for a
    seeded x (batched, B=3)."""
    rp = r_program.lower(A, RPlan(num_shards=S, **fields))
    tp = t_program.lower(_port(A), TPlan(num_shards=S, **fields))
    run = t_program.make_program_spmv_fn(tp, device="cpu")
    x = np.random.default_rng(0).standard_normal((A.ncols, 3)) \
        .astype(np.float32)
    xb, xg = run.buffers(tp.x_to_device(x))
    return r_program._device_operands(rp), run, xb, xg


def _close(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want) if scale is None else np.asarray(scale)
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want), TOL * (1.0 + scale))


def _bitwise_columns(fn, xbuf, sids):
    """fn(x) on a batch-minor (Sx, Lx, B) buffer: every batched column of
    the shards ``sids`` equals the per-vector call, bitwise."""
    rows = sids.long()
    yb = fn(xbuf)[rows]
    for b in range(xbuf.shape[2]):
        y1 = fn(xbuf[..., b:b + 1].contiguous())[rows]
        assert torch.equal(yb[:, b], y1[:, 0])


@pytest.fixture(scope="module")
def hyb_case():
    # monster rows overflow the p95 cap; the short-row shard pads
    A = r_mat.powerlaw_tail(1024, 1024 * 12, n_monster=4, seed=0)
    return _setup(A, 2, kernel="hyb", exchange="halo")


def test_ell_plain_matches_pallas_and_oracle(hyb_case):
    ops, run, xb, xg = hyb_case
    T, sids = run.operands, run.families["hyb"]
    out = t_ops.ell_stacked(T["rem_ell_data"], T["rem_ell_cols"], xg, sids)
    absd = torch.abs
    scale = t_ops.ell_stacked(absd(T["rem_ell_data"]), T["rem_ell_cols"],
                              absd(xg), sids)
    for p in sids.tolist():
        d, c = ops["rem_ell_data"][p], ops["rem_ell_cols"][p]
        assert (d == 0).any()                     # padded slots present
        xv = jnp.asarray(xg[p, :, 0].numpy())
        want = r_ell_pallas(d, c, xv, interpret=True, tile_m=8, tile_w=128)
        _close(out[p, 0], want, scale[p, 0])
        _close(out[p, 0], r_ref.ell_spmv_ref(d, c, xv), scale[p, 0])


def test_hyb_overflow_matches_reference(hyb_case):
    ops, run, xb, xg = hyb_case
    T, sids = run.operands, run.families["hyb"]
    assert ops["rem_ovf_vals"].any() or ops["loc_ovf_vals"].any()
    for pre, xbuf in (("loc_", xb), ("rem_", xg)):
        args = [T[pre + k] for k in ("ell_data", "ell_cols", "ovf_rows",
                                     "ovf_cols", "ovf_vals", "ovf_ptr")]
        out = t_ops.hyb_stacked(*args, xbuf, sids)
        for p in sids.tolist():
            xv = jnp.asarray(xbuf[p, :, 0].numpy())
            d, c, orow, ocol, oval = (ops[pre + k][p] for k in (
                "ell_data", "ell_cols", "ovf_rows", "ovf_cols", "ovf_vals"))
            # the reference executor's hyb branch (program.py:863-867)
            y = r_ell_pallas(d, c, xv, interpret=True, tile_m=8, tile_w=128)
            want = r_ops._overflow_add(y, orow, ocol, oval, xv,
                                       num_rows=ops["R"])
            _close(out[p, 0], want)
        _bitwise_columns(lambda x: t_ops.hyb_stacked(*args, x, sids), xbuf,
                         sids)


@pytest.fixture(scope="module")
def monster_case():
    # 2048-wide monster rows span 4 chunks of 512: the seg carry chain and
    # the split policy's NS > 1 both engage.
    A = r_mat.powerlaw_tail(2048, 2048 * 8, n_monster=3, seed=1)
    return A, _setup(A, 2, kernel="seg",
                     shard_kernels=("split", "seg"))


def test_seg_psum_plain_matches_pallas_and_oracle(monster_case):
    _, (ops, run, xb, xg) = monster_case
    T = run.operands
    sids = torch.arange(2, dtype=torch.int32)
    psum = spmv_seg.seg_psum(T["rem_seg_vals"], T["rem_seg_cols"], xg, sids)
    scale = spmv_seg.seg_psum(torch.abs(T["rem_seg_vals"]),
                              T["rem_seg_cols"], torch.abs(xg), sids)
    for k, p in enumerate(sids.tolist()):
        v, c = ops["rem_seg_vals"][p], ops["rem_seg_cols"][p]
        xv = jnp.asarray(xg[p, :, 0].numpy())
        want = r_seg_psum_pallas(v, c, xv, interpret=True)
        _close(psum[k, 0], want, scale[k, 0])
        _close(psum[k, 0], r_ref.seg_psum_ref(v, c, xv), scale[k, 0])


def test_seg_fixup_plain_matches_reference_fixup(monster_case):
    """Fed the same psum, the fix-up matches the reference jnp fix-up."""
    _, (ops, run, xb, xg) = monster_case
    T, sids = run.operands, run.families["seg"]
    p = int(sids[0])
    pcs = ops["rem_seg_pieces"][p]
    xv = jnp.asarray(xg[p, :, 0].numpy())
    psum_j = r_seg_psum_pallas(ops["rem_seg_vals"][p], ops["rem_seg_cols"][p],
                               xv, interpret=True)
    want = r_ops._seg_fixup(psum_j, pcs[:, 0], pcs[:, 1], pcs[:, 2],
                            pcs[:, 3], num_rows=ops["R"])
    psum_t = torch.from_numpy(np.array(psum_j))[None, None]
    out = torch.empty((2, 1, ops["R"]))
    spmv_seg.seg_fixup(psum_t, T["rem_seg_pieces"], T["rem_piece_ptr"],
                       sids, sids, num_splits=1, out=out)
    _close(out[p, 0], want)


def test_seg_family_matches_reference(monster_case):
    A, (ops, run, xb, xg) = monster_case
    T, sids = run.operands, run.families["seg"]
    args = [T["rem_" + k] for k in ("seg_vals", "seg_cols", "seg_pieces",
                                    "piece_ptr")]
    out = t_ops.seg_stacked(*args, xg, sids)
    for p in sids.tolist():
        pc = ops["rem_seg_pieces"][p]
        want = r_ops.seg_spmv(
            (ops["rem_seg_vals"][p], ops["rem_seg_cols"][p],
             ops["rem_seg_rows"][p], pc[:, 0], pc[:, 1], pc[:, 2], pc[:, 3]),
            jnp.asarray(xg[p, :, 0].numpy()), num_rows=ops["R"],
            use_kernel=True, interpret=True)
        _close(out[p, 0], want)
    _bitwise_columns(lambda x: t_ops.seg_stacked(*args, x, sids), xg, sids)


def test_split_family_matches_reference(monster_case):
    A, (ops, run, xb, xg) = monster_case
    T, sids = run.operands, run.families["split"]
    NS = ops["NS_rem"]
    assert NS > 1                                 # the policy split it
    pcs = ops["rem_seg_pieces"][int(sids[0])]
    assert (pcs[:, 1] > pcs[:, 2]).any()          # padded piece rows
    args = [T["rem_" + k] for k in ("seg_vals", "seg_cols", "seg_pieces",
                                    "piece_ptr")]
    out = t_ops.split_stacked(*args, xg, sids, num_splits=NS)
    for p in sids.tolist():
        want = r_ops.split_flat_spmv(
            ops["rem_seg_vals"][p], ops["rem_seg_cols"][p],
            ops["rem_seg_rows"][p], ops["rem_seg_pieces"][p],
            jnp.asarray(xg[p, :, 0].numpy()), num_rows=ops["R"], num_splits=NS,
            use_kernel=True, interpret=True)
        _close(out[p, 0], want)
    _bitwise_columns(lambda x: t_ops.split_stacked(
        *args, x, sids, num_splits=NS), xg, sids)


def test_split_combine_plain_matches_pallas():
    rng = np.random.default_rng(3)
    part = rng.standard_normal((64, 300)).astype(np.float32)
    want = r_combine_pallas(jnp.asarray(part), interpret=True)
    out = torch.empty((2, 1, 300))
    spmv_split.split_combine(torch.from_numpy(part)[None, None],
                             torch.tensor([1], dtype=torch.int32), out=out)
    _close(out[1, 0], want, np.abs(part).sum(0))
    _close(out[1, 0], r_ref.split_combine_ref(jnp.asarray(part)),
           np.abs(part).sum(0))


@pytest.fixture(scope="module")
def tile_case():
    A = r_mat.blocked_band(1024, 1024 * 24, seed=2)
    return _setup(A, 2, kernel="tile", exchange="halo")


def test_tile_family_matches_pallas_and_oracle(tile_case):
    ops, run, xb, xg = tile_case
    T, sids = run.operands, run.families["tile"]
    Rb = ops["R"] // 8
    assert (ops["rem_tile_brow"] == Rb).any()     # padding tiles present
    for pre, xbuf in (("loc_", xb), ("rem_", xg)):
        args = [T[pre + k] for k in ("tile_data", "tile_xcol", "tile_brow",
                                     "tile_ptr")]
        out = t_ops.tile_stacked(*args, xbuf, sids)
        scale = t_ops.tile_stacked(torch.abs(args[0]), *args[1:],
                                   torch.abs(xbuf), sids)
        for p in sids.tolist():
            d, xc, br = (ops[pre + k][p] for k in ("tile_data", "tile_xcol",
                                                   "tile_brow"))
            xv = jnp.asarray(xbuf[p, :, 0].numpy())
            want = r_ops.tile_flat_spmv(d, xc, br, xv, num_rows=ops["R"],
                                        use_kernel=True, interpret=True)
            _close(out[p, 0], want, scale[p, 0])
            _close(out[p, 0], r_ref.tile_flat_spmv_ref(
                d, xc, br, xv, num_rows=ops["R"]), scale[p, 0])
            # the per-tile products of the Pallas kernel, summed by hand
            contrib = np.asarray(r_tile_contrib_pallas(
                d, jnp.take(xv, xc, axis=0), interpret=True))
            keep = br < Rb
            y = np.zeros((Rb, 8), np.float64)
            np.add.at(y, br[keep], contrib[keep])
            _close(out[p, 0], y.reshape(-1), scale[p, 0])
        _bitwise_columns(lambda x: t_ops.tile_stacked(*args, x, sids),
                         xbuf, sids)


@pytest.mark.parametrize("kernel", ["ell", "seg", "hyb", "split", "tile"])
def test_empty_matrix(kernel):
    A = r_mat.banded(64, 256, 4, seed=0)
    A = type(A)(shape=A.shape, values=A.values[:0], col_index=A.col_index[:0],
                row_ptr=np.zeros_like(A.row_ptr))
    ops, run, xb, xg = _setup(A, 2, kernel=kernel)
    y = run(np.ones((2, 32), np.float32))
    assert torch.equal(y, torch.zeros_like(y))
