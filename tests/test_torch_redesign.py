"""What the redesigned ``tile_walk_spmv`` and ``ell_spmv`` kernels read.

The CUDA kernels cannot run here, so their read sets are emulated in
numpy, lane by lane in the kernels' own order, on inputs whose unread
cells are poisoned with NaN, and held to the reference:

* (a) the executor's ``ell_len`` table: every ``loc_`` / ``rem_`` slab
  holds only zeros (data and cols) at slots >= ``ell_len``, and
  ``ell_len`` is ``min(row nnz, W)`` of the reference's masked stage (0 for
  the other pass's rows);
* (b) the tile walk that reads only the sectors whose mask byte is
  nonzero, and of them only the marked cells, against the reference
  ``tile_walk_spmv`` in interpret mode (rtol = atol = 1e-5 on |A|·|x|:
  the same products, summed in another order);
* (c) the ELL walk bounded by ``ell_len``, with the HYB overflow in
  stored order, against the reference ``ell_spmv`` in interpret mode plus
  its overflow scatter (1e-5 on |A|·|x|) and, assembled per row from the
  two passes, against the reference numpy executor (2e-4 on |A|·|x|, the
  float32 device path against float64).
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.program as r_program
import repro.data.matrices as r_mat
import repro.kernels.ops as r_ops
from repro.core.sparse_matrix import csr_row_nnz
from repro.core.spmv import SpmvPlan as RPlan
from repro.kernels.spmv_ell import ell_spmv as r_ell_pallas
from repro.kernels.spmv_tile import tile_walk_spmv as r_tile_walk_pallas

import repro_torch.core.program as t_program
from repro_torch.core.sparse_matrix import CSRMatrix
from repro_torch.core.spmv import SpmvPlan as TPlan
from repro_torch.kernels import _lib

from test_torch_host import GENERATORS, PLANS

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

KERNEL_TOL = 1e-5
E2E_TOL = 2e-4


def _port(A):
    return CSRMatrix(shape=A.shape, values=A.values, col_index=A.col_index,
                     row_ptr=A.row_ptr)


def _stored_zeros(A, every=7):
    """A with every 7th entry an explicit zero (kept in every format)."""
    vals = A.values.copy()
    vals[::every] = 0.0
    return dataclasses.replace(A, values=vals)


def _within(got, want, scale, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want),
                                 tol * (1.0 + np.asarray(scale)))


def _fma(acc, a, b):
    """float32 fused multiply-add (the float64 product of two float32s is
    exact; one rounding, as fmaf, up to a rare double rounding)."""
    return np.float32(np.float64(acc) + np.float64(a) * np.float64(b))


# --------------------------------------------------------------------------
# (a) the ell_len table
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(GENERATORS))
def matrix(request):
    return GENERATORS[request.param]()


@pytest.mark.parametrize("fields", PLANS, ids=lambda f: "-".join(
    str(v) if not isinstance(v, tuple) else "mixed" for v in f.values()))
def test_ell_len_bounds_the_real_slots(matrix, fields):
    S = 4
    rp = r_program.lower(matrix, RPlan(num_shards=S, **fields))
    tp = t_program.lower(_port(matrix), TPlan(num_shards=S, **fields))
    ops = t_program._device_operands(tp)
    flags = r_program._row_remote_flags(rp)
    for pre, owned in (("loc_", False), ("rem_", True)):
        data, cols = ops[pre + "ell_data"], ops[pre + "ell_cols"]
        ell_len = ops[pre + "ell_len"]
        assert ell_len.shape == data.shape[:2] and ell_len.dtype == np.int32
        past = np.arange(data.shape[2]) >= ell_len[..., None]
        assert not data[past].any() and not cols[past].any()
        want = np.zeros_like(ell_len)
        for p, st in enumerate(rp.stages):
            rr = flags[st.row_offset: st.row_offset + st.rows]
            keep = rr == owned
            sub = rp.partition.shard_csr(rp.matrix, p)
            masked = r_program._masked_stage(sub, keep, st)
            if masked.ell is not None:
                nnz = np.where(keep, csr_row_nnz(sub), 0)
                want[p, : st.rows] = np.minimum(nnz, masked.ell.width)
        np.testing.assert_array_equal(ell_len, want)


# --------------------------------------------------------------------------
# (b) the tile walk's read set
# --------------------------------------------------------------------------

def emulate_tile_walk(t, x):
    """The kernel's reads and sums for one vector: warp (block row mb, 8-row
    group g); lane (u, r) walks row g*8 + r of the tiles t_lo + u,
    t_lo + u + 4, ...; per tile it reads the row's 16 mask bytes, then only
    the sectors (8 cells) whose byte is nonzero, and adds the marked cells
    in ascending column; the 4 slots end in the butterfly
    (s0 + s1) + (s2 + s3).  Cells of unoccupied sectors are NaN, so a read
    of one would show."""
    bm, bn = t.bm, t.bn
    bits = np.unpackbits(t.mask, axis=2, count=bn).astype(bool)
    sector_on = t.mask != 0                                 # (T, bm, bn/8)
    seen = np.where(np.repeat(sector_on, 8, axis=2), t.data, np.nan)
    Mb = len(t.tile_ptr) - 1
    y = np.zeros(Mb * bm, np.float32)
    for mb in range(Mb):
        lo, hi = int(t.tile_ptr[mb]), int(t.tile_ptr[mb + 1])
        for row in range(bm):
            acc = [np.float32(0)] * 4
            for u in range(4):
                for ti in range(lo + u, hi, 4):
                    base = int(t.tile_cols[ti]) * bn
                    for j in np.flatnonzero(bits[ti, row]):
                        acc[u] = _fma(acc[u], seen[ti, row, j], x[base + j])
            s01, s23 = np.float32(acc[0] + acc[1]), np.float32(acc[2] + acc[3])
            y[mb * bm + row] = np.float32(s01 + s23)
    return y


TILE_MATRICES = {
    "blocked_band": lambda: r_mat.blocked_band(512, 512 * 24, seed=1),
    "powerlaw_tail": lambda: r_mat.powerlaw_tail(1024, 1024 * 8,
                                                 n_monster=2, seed=2),
    "mixed_structure": lambda: r_mat.mixed_structure(256, 256 * 6, seed=0),
}


@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("name", sorted(TILE_MATRICES))
def test_tile_read_set_matches_reference(name, bm):
    A = _stored_zeros(TILE_MATRICES[name]())
    t = r_ops.tile_from_csr(A, bm=bm)
    assert (t.data[t.occupancy()] == 0).any()          # a stored zero
    assert (t.mask == 0).any()                          # skipped sectors
    x = np.random.default_rng(3).standard_normal(A.ncols).astype(np.float32)
    got = emulate_tile_walk(t, x)
    Nb = max(-(-A.ncols // t.bn), 1)
    xp = np.zeros(Nb * t.bn, np.float32)
    xp[: A.ncols] = x
    c, tid, bc = r_ops._tile_walk_tables(t)
    want = r_tile_walk_pallas(t.data, c, tid, bc, jnp.asarray(xp),
                              interpret=True)
    absd = np.abs(t.data)
    scale = r_tile_walk_pallas(absd, c, tid, bc, jnp.asarray(np.abs(xp)),
                               interpret=True)
    _within(got, want, scale, KERNEL_TOL)


# --------------------------------------------------------------------------
# (c) the ELL walk's read set
# --------------------------------------------------------------------------

def emulate_ell(ops, pre, xbuf, G):
    """The kernel's reads and sums over every shard of one pass, one vector:
    a group of G lanes a row; lane l adds slots l, l + G, ... below
    ell_len[s, r] in order; a butterfly over the G lanes; then the row's
    overflow entries in stored order.  Slots past ell_len are NaN."""
    data, cols = ops[pre + "ell_data"], ops[pre + "ell_cols"]
    ell_len, ovf_ptr = ops[pre + "ell_len"], ops[pre + "ovf_ptr"]
    ovf_cols, ovf_vals = ops[pre + "ovf_cols"], ops[pre + "ovf_vals"]
    S, R, W = data.shape
    seen = np.where(np.arange(W) < ell_len[..., None], data, np.nan)
    y = np.zeros((S, R), np.float32)
    for s in range(S):
        xv = xbuf[s if xbuf.shape[0] > 1 else 0]
        for r in range(R):
            part = [np.float32(0)] * G
            for w in range(int(ell_len[s, r])):
                part[w % G] = _fma(part[w % G], seen[s, r, w],
                                   xv[cols[s, r, w]])
            off = G // 2
            while off:
                part = [np.float32(part[i] + part[i ^ off]) for i in range(G)]
                off //= 2
            acc = part[0]
            for o in range(int(ovf_ptr[s, r]), int(ovf_ptr[s, r + 1])):
                acc = np.float32(acc + np.float32(ovf_vals[s, o]
                                                  * xv[ovf_cols[s, o]]))
            y[s, r] = acc
    return y


ELL_PLANS = {
    "hyb-halo": dict(kernel="hyb", exchange="halo"),
    "ell-cyclic": dict(kernel="ell", layout="cyclic", exchange="allgather"),
}


@pytest.mark.parametrize("plan", sorted(ELL_PLANS))
def test_ell_read_set_matches_reference(plan):
    # monster rows overflow the HYB cap; each pass holds the other pass's
    # rows at length 0
    A = _stored_zeros(r_mat.powerlaw_tail(1024, 1024 * 12, n_monster=4,
                                          seed=0))
    fields = dict(num_shards=2, **ELL_PLANS[plan])
    rp = r_program.lower(A, RPlan(**fields))
    tp = t_program.lower(_port(A), TPlan(**fields))
    ops = t_program._device_operands(tp)
    run = t_program.make_program_spmv_fn(tp, device="cpu")
    x = np.random.default_rng(0).standard_normal(A.ncols).astype(np.float32)
    xb, xg = (b[..., 0].numpy() for b in run.buffers(tp.x_to_device(x)))
    G = int(re.search(r"constexpr int G = (\d+);",
                      (_lib.CSRC / "spmv_ell.cu").read_text()).group(1))
    y = {}
    for pre, xbuf in (("loc_", xb), ("rem_", xg)):
        assert (ops[pre + "ell_len"] == 0).any()
        y[pre] = emulate_ell(ops, pre, xbuf, G)
        for p in range(2):
            xv = jnp.asarray(xbuf[p if xbuf.shape[0] > 1 else 0])
            d, c, orow, ocol, oval = (ops[pre + k][p] for k in (
                "ell_data", "ell_cols", "ovf_rows", "ovf_cols", "ovf_vals"))
            # the reference executor's hyb branch (program.py:863-867)
            want = r_ops._overflow_add(
                r_ell_pallas(d, c, xv, interpret=True, tile_m=8, tile_w=128),
                orow, ocol, oval, xv, num_rows=ops["R"])
            scale = r_ops._overflow_add(
                r_ell_pallas(np.abs(d), c, jnp.abs(xv), interpret=True,
                             tile_m=8, tile_w=128),
                orow, ocol, np.abs(oval), jnp.abs(xv), num_rows=ops["R"])
            _within(y[pre][p], want, scale, KERNEL_TOL)
    assert ops["rem_ovf_vals"].any() or plan == "ell-cyclic"
    y_shards = np.where(ops["row_remote"], y["rem_"], y["loc_"])
    got = t_program.gather_b(tp, y_shards)
    want = r_program.execute(rp, x.astype(np.float64), backend="numpy")
    absA = dataclasses.replace(A, values=np.abs(A.values))
    scale = r_program.execute(r_program.lower(absA, RPlan(**fields)),
                              np.abs(x).astype(np.float64), backend="numpy")
    _within(got, want, scale, E2E_TOL)
