"""The lowered SpMV program and its executors, on PyTorch.

Counterpart of ``repro.core.program``:

* :func:`lower` turns a host CSR matrix plus an :class:`SpmvPlan` into an
  :class:`SpmvProgram` (reordering, partition, vector layouts, traffic
  accounting, one :class:`ShardStage` per shard in its kernel family);
  :func:`program_from_arrays` builds the same program from the host
  arrays of an already reordered and partitioned matrix.
* :func:`relower` rebuilds only the stages whose kernel (or effective
  split count) changed, sharing every other stage with the old program.
* :func:`execute` runs it: ``backend="numpy"`` is the exact float64 host
  oracle, ``backend="device"`` the executor of
  :func:`make_program_spmv_fn`, ``backend="emu"`` the Emu timeline probe
  (:func:`probe_program`).

The device executor keeps all S shards on one device.  The exchange
prologue becomes one index gather that builds each shard's
``[x_local ++ recv]`` buffer (or the one global vector of a uniform
all-gather program); each kernel family is one launch over its shards'
S-stacked operands; and, as in the reference, a local pass (rows that
read only the shard's own x) and a remote pass (rows that wait for the
exchange) are combined per row.  No kernel uses atomics, so the result is
bitwise-deterministic: ``pipeline=True`` and ``False`` agree bitwise, and
column b of an (N, B) call equals the per-vector call on ``x[:, b]``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .emu import EmuConfig, EmuResult, run_spmv
from .layout import VectorLayout, make_layout
from .migration import TrafficReport, count_migrations, remote_access_matrix
from .partition import Partition, make_partition
from .plan import split_meta
from .reorder import reordering_permutation
from .sparse_matrix import CSRMatrix, ELL_LANE, ELL_SUBLANE, EllMatrix, \
    SegMatrix, SplitMatrix, TileMatrix, csr_row_nnz, csr_to_ell
from .spmv import PLAN_KERNELS, SpmvPlan
from ..kernels import ops as kops
from ..kernels.ops import resolve_device

__all__ = ["ShardStage", "SpmvProgram", "lower", "relower",
           "program_from_arrays", "resolve_device", "execute",
           "make_program_spmv_fn", "probe_program", "gather_b",
           "PROGRAM_KERNELS"]

#: Kernels a shard stage may select; a stage's kernel id is its index.
PROGRAM_KERNELS = PLAN_KERNELS


@dataclasses.dataclass(frozen=True)
class ShardStage:
    """One shard's stage: its kernel family and host payload.

    ``ell`` is set for ``ell`` and ``hyb`` stages, ``seg`` / ``split`` /
    ``tile`` for theirs.  ``rows``/``row_offset`` locate the shard's rows
    in the program's (reordered) matrix.
    """

    shard: int
    kernel: str                    # "ell" | "seg" | "hyb" | "split" | "tile"
    rows: int                      # true row count
    row_offset: int                # absolute first row
    nnz: int
    ell: EllMatrix | None = None
    seg: SegMatrix | None = None
    split: SplitMatrix | None = None
    tile: TileMatrix | None = None


def _shard_max_row_nnz(A: CSRMatrix, part: Partition, p: int) -> int:
    r0, r1 = int(part.starts[p]), int(part.starts[p + 1])
    if r1 <= r0:
        return 0
    return int((A.row_ptr[r0 + 1: r1 + 1] - A.row_ptr[r0: r1]).max())


def _resolved_split_count(A: CSRMatrix, part: Partition, p: int,
                          requested: int) -> int:
    """The split count shard p lowers with: the request (or the
    :func:`split_meta` policy when it is 0), clamped to the chunk count."""
    r0, r1 = int(part.starts[p]), int(part.starts[p + 1])
    nnz_p = int(A.row_ptr[r1] - A.row_ptr[r0])
    L = ((kops.SEG_CHUNK + ELL_LANE - 1) // ELL_LANE) * ELL_LANE
    C = max(-(-nnz_p // L), 1)
    ns = requested if requested > 0 else \
        split_meta(nnz_p, _shard_max_row_nnz(A, part, p))
    return max(1, min(int(ns), C))


def _build_stage(A: CSRMatrix, part: Partition, p: int,
                 kernel: str, split_count: int = 0) -> ShardStage:
    r0, r1 = int(part.starts[p]), int(part.starts[p + 1])
    sub = part.shard_csr(A, p)
    ell = seg = split = tile = None
    if kernel == "ell":
        ell = csr_to_ell(sub)
    elif kernel == "hyb":
        ell = kops.hyb_from_csr(sub)
    elif kernel == "seg":
        seg = kops.seg_from_csr(sub)
    elif kernel == "split":
        ns = _resolved_split_count(A, part, p, split_count)
        split = kops.split_from_csr(sub, ns)
    elif kernel == "tile":
        tile = kops.tile_from_csr(sub)
    else:
        raise ValueError(f"unknown shard kernel {kernel!r}; expected one of "
                         f"{PROGRAM_KERNELS}")
    return ShardStage(shard=p, kernel=kernel, rows=r1 - r0, row_offset=r0,
                      nnz=sub.nnz, ell=ell, seg=seg, split=split, tile=tile)


@dataclasses.dataclass
class SpmvProgram:
    """A lowered SpMV program + its traffic accounting (host, numpy)."""

    plan: SpmvPlan
    matrix: CSRMatrix                 # reordered matrix (host)
    partition: Partition
    x_layout: VectorLayout
    b_layout: VectorLayout
    rows_per_shard: np.ndarray        # true row counts (S,)
    row_offset: np.ndarray            # absolute first row per shard (S,)
    traffic: TrafficReport
    shard_traffic: np.ndarray         # (S, S) x-elements moved p<-q
    stages: tuple                     # (S,) ShardStage
    perm: np.ndarray | None = None    # perm[old] = new; None = identity

    def shard_kernels(self) -> tuple:
        return tuple(st.kernel for st in self.stages)

    def x_to_device(self, x: np.ndarray) -> np.ndarray:
        """(N[, B]) in the program's order -> (S, per[, B]) layout order."""
        return self.x_layout.to_sharded(x)

    def b_from_device(self, b_shards: np.ndarray) -> np.ndarray:
        return self.b_layout.from_sharded(b_shards)


def _legacy_view(self):
    raise NotImplementedError(
        "the legacy stacked-slab views (data/cols/seg_*) are not ported yet: "
        "the port's executor builds its own S-stacked operands (see "
        "_device_operands); the reference has them in repro.core.program")


for _name in ("data", "cols", "seg_vals", "seg_cols", "seg_rows",
              "seg_pieces"):
    setattr(SpmvProgram, _name, property(_legacy_view))


# --------------------------------------------------------------------------
# lowering
# --------------------------------------------------------------------------

def program_from_arrays(*, shape, values, col_index, row_ptr, starts, plan,
                        perm=None) -> SpmvProgram:
    """Build the program from host arrays: the (already reordered) CSR
    matrix, the partition's row starts, the plan (an :class:`SpmvPlan` or
    a dict of its fields) and the reordering ``perm`` (or None).

    This is how a program lowered elsewhere (the JAX reference) is carried
    over: its arrays in, the same stages out.
    """
    if isinstance(plan, dict):
        plan = SpmvPlan(**plan)
    A = CSRMatrix(shape=tuple(int(d) for d in shape),
                  values=np.asarray(values),
                  col_index=np.asarray(col_index, dtype=np.int32),
                  row_ptr=np.asarray(row_ptr, dtype=np.int64))
    strategy = "row" if plan.distribution == "row" else "nonzero"
    part = Partition(strategy, plan.num_shards,
                     np.asarray(starts, dtype=np.int64))
    x_layout = make_layout(plan.layout, A.ncols, plan.num_shards)
    b_layout = make_layout(plan.layout, A.nrows, plan.num_shards)
    kernels = plan.resolved_shard_kernels()
    split_counts = plan.resolved_split_counts()
    stages = tuple(_build_stage(A, part, p, kernels[p], split_counts[p])
                   for p in range(plan.num_shards))
    return SpmvProgram(
        plan=plan, matrix=A, partition=part, x_layout=x_layout,
        b_layout=b_layout,
        rows_per_shard=part.rows_per_shard().astype(np.int64),
        row_offset=part.starts[:-1].astype(np.int64),
        traffic=count_migrations(A, part, x_layout, b_layout),
        shard_traffic=remote_access_matrix(A, part, x_layout),
        stages=stages, perm=None if perm is None else np.asarray(perm))


def lower(csr: CSRMatrix, plan: SpmvPlan) -> SpmvProgram:
    """Lower (matrix, plan) to a per-shard-staged :class:`SpmvProgram`."""
    if csr.nrows != csr.ncols:
        raise ValueError("paper applies symmetric reorderings to square "
                         "matrices")
    perm = None
    A = csr
    if plan.reordering != "none":
        perm = reordering_permutation(csr, plan.reordering, seed=plan.seed,
                                      parts=plan.num_shards)
        A = csr.permuted(perm, perm)
    part = make_partition(A, plan.num_shards, plan.distribution)
    return program_from_arrays(shape=A.shape, values=A.values,
                               col_index=A.col_index, row_ptr=A.row_ptr,
                               starts=part.starts, plan=plan, perm=perm)


#: Plan fields that force a full :func:`lower` when they change.  The
#: exchange (uniform or per-shard) is not one of them: stages, partition
#: and traffic accounting do not depend on it; the executor's operands are
#: rebuilt per program object.
_BASE_FIELDS = ("layout", "distribution", "reordering", "num_shards", "seed")


def relower(program: SpmvProgram, new_plan: SpmvPlan) -> SpmvProgram:
    """Re-lower only the stages whose kernel (or effective split count)
    changed, keeping the same base.

    The base (layout / distribution / reordering / shards / seed) must
    match the incumbent plan (``ValueError`` otherwise); matrix,
    partition, layouts and traffic are shared, and unchanged stages are
    the *same objects* as the old program's.  An exchange-only change
    shares every stage.
    """
    old_plan = program.plan
    for f in _BASE_FIELDS:
        if getattr(new_plan, f) != getattr(old_plan, f):
            raise ValueError(
                f"relower only changes shard kernels; base field {f!r} "
                f"differs ({getattr(old_plan, f)!r} -> "
                f"{getattr(new_plan, f)!r}) — use lower()")
    old_k = old_plan.resolved_shard_kernels()
    new_k = new_plan.resolved_shard_kernels()
    new_sc = new_plan.resolved_split_counts()

    def unchanged(p: int) -> bool:
        if new_k[p] != old_k[p]:
            return False
        if new_k[p] != "split":
            return True
        # a split request that clamps to the same effective NS shares too
        want = _resolved_split_count(program.matrix, program.partition, p,
                                     new_sc[p])
        return program.stages[p].split.num_splits == want

    stages = tuple(
        program.stages[p] if unchanged(p)
        else _build_stage(program.matrix, program.partition, p, new_k[p],
                          new_sc[p])
        for p in range(new_plan.num_shards))
    return dataclasses.replace(program, plan=new_plan, stages=stages)


# --------------------------------------------------------------------------
# numpy executor (exact float64 host oracle)
# --------------------------------------------------------------------------

def _apply_perm(v: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """v in old order -> v in new order (perm[old] = new)."""
    out = np.empty_like(v)
    out[perm] = v
    return out


def _execute_numpy(program: SpmvProgram, x: np.ndarray) -> np.ndarray:
    """y = A @ x on the host, caller index order, float64; ``x`` is (N,) or
    (N, B).  Batch-major, so column b equals the per-vector call bitwise."""
    if x.shape[0] != program.matrix.ncols:
        raise ValueError(f"x has {x.shape[0]} elements, matrix expects "
                         f"{program.matrix.ncols}")
    if x.ndim == 1:
        return _execute_numpy_block(program, x[:, None])[:, 0]
    if x.ndim != 2:
        raise ValueError(f"x must be (N,) or (N, B), got shape {x.shape}")
    return _execute_numpy_block(program, x)


def _execute_numpy_block(program: SpmvProgram, x: np.ndarray) -> np.ndarray:
    B = x.shape[1]
    xr = x if program.perm is None else _apply_perm(x, program.perm)
    x_pad = np.zeros((B, program.x_layout.padded_length()), dtype=np.float64)
    x_pad[:, : program.matrix.ncols] = xr.T

    y = np.zeros((B, program.matrix.nrows), dtype=np.float64)
    for st in program.stages:
        if st.rows == 0:
            continue
        o, r = st.row_offset, st.rows
        if st.kernel == "seg":
            seg = st.seg
            contrib = seg.vals.astype(np.float64) * x_pad[:, seg.cols]
            yp = np.zeros((B, r))
            for b in range(B):            # padded slots: row 0, val 0
                np.add.at(yp[b], seg.rows, contrib[b])
            y[:, o:o + r] = yp
        elif st.kernel == "split":
            spl = st.split                # two-stage: partials, then combine
            contrib = spl.vals.astype(np.float64) * x_pad[:, spl.cols]
            s_ix = np.broadcast_to(
                np.arange(spl.num_splits)[:, None, None], spl.rows.shape)
            partial = np.zeros((B, spl.num_splits, r))
            for b in range(B):
                np.add.at(partial[b], (s_ix, spl.rows), contrib[b])
            y[:, o:o + r] = partial.sum(axis=1)
        elif st.kernel == "tile":
            tl = st.tile
            N = tl.shape[1]
            Nb = max(-(-N // tl.bn), 1)
            xw = np.zeros((B, Nb * tl.bn))
            xw[:, :N] = x_pad[:, :N]
            gathered = xw.reshape(B, Nb, tl.bn)[:, tl.tile_cols]  # (B,T,bn)
            contrib = (tl.data.astype(np.float64)[None]
                       * gathered[:, :, None, :]).sum(axis=3)     # (B,T,bm)
            Mb = max(-(-r // tl.bm), 1)
            yp = np.zeros((B, Mb, tl.bm))
            for b in range(B):
                np.add.at(yp[b], tl.tile_rows, contrib[b])
            y[:, o:o + r] = yp.reshape(B, Mb * tl.bm)[:, :r]
        else:                             # "ell" / "hyb"
            e = st.ell
            slab = e.data.astype(np.float64) * x_pad[:, e.cols]
            y[:, o:o + r] = np.ascontiguousarray(slab).sum(axis=2)[:, :r]
            if e.overflow_vals.size:      # hyb COO tail
                ovals = e.overflow_vals.astype(np.float64)
                for b in range(B):
                    np.add.at(y[b], o + e.overflow_rows,
                              ovals * x_pad[b, e.overflow_cols])
    yt = y.T
    return yt if program.perm is None else yt[program.perm]


# --------------------------------------------------------------------------
# device operands (host, numpy; bitwise-equal to the reference's)
# --------------------------------------------------------------------------

def _halo_tables(program: SpmvProgram):
    """Exchange tables ``(send_idx, pos_map, H)``: ``send_idx[q, p]`` are
    the sender-local x indices q sends reader p (the exact halo for a
    ``halo`` reader, all of q's columns for an ``allgather`` reader, padded
    to H) and ``pos_map[p, g]`` the position of global id g in reader p's
    ``[x_local ++ recv]`` buffer (``per + q * H + slot``)."""
    A, part, lay = program.matrix, program.partition, program.x_layout
    S = part.num_shards
    per = lay.padded_length() // S
    policies = program.plan.resolved_shard_exchanges()
    rows_of_nnz = np.repeat(np.arange(A.nrows), np.diff(A.row_ptr))
    home = part.owner_of_rows(A.nrows)[rows_of_nnz]
    owners = lay.owner_of(A.col_index)
    rem = (A.values != 0) & (owners != home)
    needed = [[np.zeros(0, np.int64)] * S for _ in range(S)]
    if rem.any():
        key = home[rem].astype(np.int64) * A.ncols + \
            A.col_index[rem].astype(np.int64)
        uniq = np.unique(key)             # sorted: per reader, by global id
        up, ucol = uniq // A.ncols, uniq % A.ncols
        uq = lay.owner_of(ucol)
        for p in range(S):
            if policies[p] != "halo":
                continue
            for q in range(S):
                needed[p][q] = ucol[(up == p) & (uq == q)]
    if any(e == "allgather" for e in policies):
        col_owner = lay.owner_of(np.arange(A.ncols))
        owned = [np.flatnonzero(col_owner == q).astype(np.int64)
                 for q in range(S)]
        for p in range(S):
            if policies[p] == "allgather":
                for q in range(S):
                    if q != p:
                        needed[p][q] = owned[q]
    H = max(max((ids.size for row in needed for ids in row), default=1), 1)
    send_idx = np.zeros((S, S, H), dtype=np.int32)
    pos_map = np.zeros((S, A.ncols), dtype=np.int32)
    for p in range(S):
        for q in range(S):
            ids = needed[p][q]
            if ids.size:
                send_idx[q, p, : ids.size] = lay.local_index(ids)
                pos_map[p, ids] = per + q * H + np.arange(ids.size)
    return send_idx, pos_map, H


def _remap_cols(cols: np.ndarray, vals: np.ndarray, lay: VectorLayout,
                p: int, pos_map_p: np.ndarray) -> np.ndarray:
    """Global col ids -> positions in shard p's [x_local ++ recv] buffer;
    zero-valued slots keep position 0."""
    own = lay.owner_of(cols)
    out = np.where(own == p, lay.local_index(cols), 0).astype(np.int32)
    m = (own != p) & (vals != 0)
    if m.any():
        out[m] = pos_map_p[cols[m]]
    return out


def _row_remote_flags(program: SpmvProgram) -> np.ndarray:
    """(nrows,) bool — rows with >= 1 stored non-zero reading a remote x
    entry; all other rows are computable from ``x_local`` alone."""
    A, part, lay = program.matrix, program.partition, program.x_layout
    rows_of_nnz = np.repeat(np.arange(A.nrows), np.diff(A.row_ptr))
    home = part.owner_of_rows(A.nrows)[rows_of_nnz]
    owners = lay.owner_of(A.col_index)
    rem = (A.values != 0) & (owners != home)
    flags = np.zeros(A.nrows, dtype=bool)
    flags[rows_of_nnz[rem]] = True
    return flags


def _row_masked_csr(sub: CSRMatrix, keep: np.ndarray) -> CSRMatrix:
    """Same-shape CSR with the entries of non-kept rows dropped."""
    if keep.all():
        return sub
    per_row = np.diff(sub.row_ptr)
    rows = np.repeat(np.arange(sub.nrows), per_row)
    m = keep[rows]
    counts = np.bincount(rows[m], minlength=sub.nrows)
    row_ptr = np.zeros(sub.nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSRMatrix(shape=sub.shape, values=sub.values[m],
                     col_index=sub.col_index[m], row_ptr=row_ptr)


def _masked_stage(sub: CSRMatrix, keep: np.ndarray,
                  st: ShardStage) -> ShardStage:
    """Lower one row slice (local or remote) of a shard into the same
    kernel family as its full stage."""
    m = _row_masked_csr(sub, keep)
    ell = seg = split = tile = None
    if st.kernel == "ell":
        ell = csr_to_ell(m)
    elif st.kernel == "hyb":
        ell = kops.hyb_from_csr(m)
    elif st.kernel == "seg":
        seg = kops.seg_from_csr(m)
    elif st.kernel == "tile":
        tile = kops.tile_from_csr(m)
    else:                                    # "split"
        L = ((kops.SEG_CHUNK + ELL_LANE - 1) // ELL_LANE) * ELL_LANE
        C = max(-(-m.nnz // L), 1)
        ns = max(1, min(st.split.num_splits, C))
        split = kops.split_from_csr(m, ns)
    return ShardStage(shard=st.shard, kernel=st.kernel, rows=st.rows,
                      row_offset=st.row_offset, nnz=m.nnz, ell=ell, seg=seg,
                      split=split, tile=tile)


def _row_ranges(sorted_ids: np.ndarray, n: int) -> np.ndarray:
    """(n+1,) int32 run starts of ids 0..n in a sorted id list."""
    return np.searchsorted(sorted_ids, np.arange(n + 1),
                           side="left").astype(np.int32)


def _stack_stages(stages, R: int, remap, row_nnz) -> dict:
    """Stack a per-shard stage list into one uniform-shape operand set.

    The arrays are the reference's (``ell_*``, ``ovf_*``, ``seg_*``,
    ``tile_*``, padded to the largest shard; split slabs flatten into the
    seg operand with the 5-column piece table [flat_chunk, lo, hi, row,
    split]; padding tiles carry block row Rb).  Three range tables are
    added for the kernels, each built with searchsorted over a shard's
    real, row-sorted entries: ``ovf_ptr`` (S, R+1) over the overflow rows,
    ``piece_ptr`` (S, R+1) over the piece rows and ``tile_ptr`` (S, Rb+1)
    over the tiles' block rows.  A fourth, ``ell_len`` (S, R), counts each
    row's real ELL slots: ``min(row nnz, W)`` of the stage's own ELL width
    from ``row_nnz`` (each stage's row lengths, rows it does not own 0),
    HYB rows spilling past W; 0 for padding rows and other families.
    """
    S = len(stages)
    ells = [st.ell for st in stages if st.ell is not None]
    W = max((e.width for e in ells), default=ELL_LANE)
    O = max((e.overflow_vals.size for e in ells), default=0)
    O = max(O, 1)
    segs = [st.seg for st in stages if st.seg is not None]
    spls = [st.split for st in stages if st.split is not None]
    slabs = segs + spls
    L = slabs[0].chunk if slabs else kops.SEG_CHUNK
    if slabs and any(s.chunk != L for s in slabs):
        raise AssertionError("seg/split stages must share one chunk size")
    C = max(max((s.num_chunks for s in segs), default=ELL_SUBLANE),
            max((s.num_splits * s.chunks_per_split for s in spls),
                default=ELL_SUBLANE))
    C = _round_up(C, ELL_SUBLANE)
    NS = max((s.num_splits for s in spls), default=1)
    Pp = max(max((s.n_pieces for s in segs), default=0),
             max((s.n_pieces for s in spls), default=0))
    Pp = max(Pp, 1)

    ell_data = np.zeros((S, R, W), dtype=np.float32)
    ell_cols = np.zeros((S, R, W), dtype=np.int32)
    ovf_rows = np.zeros((S, O), dtype=np.int32)
    ovf_cols = np.zeros((S, O), dtype=np.int32)
    ovf_vals = np.zeros((S, O), dtype=np.float32)
    ovf_ptr = np.zeros((S, R + 1), dtype=np.int32)
    ell_len = np.zeros((S, R), dtype=np.int32)
    seg_vals = np.zeros((S, C, L), dtype=np.float32)
    seg_cols = np.zeros((S, C, L), dtype=np.int32)
    seg_rows = np.zeros((S, C, L), dtype=np.int32)
    seg_pieces = np.zeros((S, Pp, 5), dtype=np.int32)
    seg_pieces[:, :, 1] = 1           # (lo=1, hi=0, row=0, split=0) -> zero
    piece_ptr = np.zeros((S, R + 1), dtype=np.int32)
    tiles = [st.tile for st in stages if st.tile is not None]
    t_bm = tiles[0].bm if tiles else ELL_SUBLANE
    t_bn = tiles[0].bn if tiles else ELL_LANE
    if any((t.bm, t.bn) != (t_bm, t_bn) for t in tiles):
        raise AssertionError("tile stages must share one tile shape")
    Tp = max(max((t.num_tiles for t in tiles), default=0), 1)
    Rb = -(-R // t_bm)
    tile_data = np.zeros((S, Tp, t_bm, t_bn), dtype=np.float32)
    tile_xcol = np.zeros((S, Tp, t_bn), dtype=np.int32)
    tile_brow = np.full((S, Tp), Rb, dtype=np.int32)   # pad: drops
    tile_ptr = np.zeros((S, Rb + 1), dtype=np.int32)

    for p, st in enumerate(stages):
        if st.ell is not None:
            e = st.ell
            r, w = e.data.shape
            ell_data[p, :r, :w] = e.data
            ell_cols[p, :r, :w] = remap(e.cols, e.data, p)
            ell_len[p, :len(row_nnz[p])] = np.minimum(row_nnz[p], w)
            n = e.overflow_vals.size
            if n:
                ovf_rows[p, :n] = e.overflow_rows
                ovf_cols[p, :n] = remap(e.overflow_cols, e.overflow_vals, p)
                ovf_vals[p, :n] = e.overflow_vals
                ovf_ptr[p] = _row_ranges(e.overflow_rows, R)
        if st.seg is not None:
            s = st.seg
            seg_vals[p, : s.num_chunks] = s.vals
            seg_cols[p, : s.num_chunks] = remap(s.cols, s.vals, p)
            seg_rows[p, : s.num_chunks] = s.rows
            n = s.n_pieces
            seg_pieces[p, :n, 0] = s.piece_chunk
            seg_pieces[p, :n, 1] = s.piece_lo
            seg_pieces[p, :n, 2] = s.piece_hi
            seg_pieces[p, :n, 3] = s.piece_row
            piece_ptr[p] = _row_ranges(s.piece_row, R)
        if st.split is not None:
            s = st.split
            ns, Cs = s.num_splits, s.chunks_per_split
            fv = s.vals.reshape(ns * Cs, L)
            seg_vals[p, : ns * Cs] = fv
            seg_cols[p, : ns * Cs] = remap(s.cols.reshape(ns * Cs, L), fv, p)
            seg_rows[p, : ns * Cs] = s.rows.reshape(ns * Cs, L)
            n = s.n_pieces
            seg_pieces[p, :n, 0] = s.piece_split * Cs + s.piece_chunk
            seg_pieces[p, :n, 1] = s.piece_lo
            seg_pieces[p, :n, 2] = s.piece_hi
            seg_pieces[p, :n, 3] = s.piece_row
            seg_pieces[p, :n, 4] = s.piece_split
            piece_ptr[p] = _row_ranges(s.piece_row, R)
        if st.tile is not None and st.tile.num_tiles:
            t = st.tile
            T = t.num_tiles
            tile_data[p, :T] = t.data
            gcols = np.minimum(
                t.tile_cols[:, None].astype(np.int64) * t_bn
                + np.arange(t_bn, dtype=np.int64)[None, :],
                t.shape[1] - 1)                        # (T, bn) global ids
            lane_nz = (t.data != 0).any(axis=1).astype(np.float32)
            tile_xcol[p, :T] = remap(np.where(lane_nz != 0, gcols, 0),
                                     lane_nz, p)
            tile_brow[p, :T] = t.tile_rows
        tile_ptr[p] = _row_ranges(tile_brow[p], Rb)
    return dict(ell_data=ell_data, ell_cols=ell_cols, ovf_rows=ovf_rows,
                ovf_cols=ovf_cols, ovf_vals=ovf_vals, ovf_ptr=ovf_ptr,
                ell_len=ell_len,
                seg_vals=seg_vals, seg_cols=seg_cols, seg_rows=seg_rows,
                seg_pieces=seg_pieces, piece_ptr=piece_ptr,
                tile_data=tile_data, tile_xcol=tile_xcol,
                tile_brow=tile_brow, tile_ptr=tile_ptr, NS=NS)


def _device_operands(program: SpmvProgram) -> dict:
    """The executor's host operand sets (cached on the program).

    Each shard is split by row into a local slice (rows reading only x
    the shard owns; ``loc_*``, columns remapped to ``x_local`` positions)
    and a remote slice (``rem_*``, columns into the exchange buffer:
    ``[x_local ++ recv]`` when any shard reads a halo, the global x for a
    uniform all-gather).  ``row_remote`` picks, per row, which pass owns
    the result.  Every array the reference builds is bitwise-equal to it;
    the kernels' range and length tables (``ovf_ptr``, ``piece_ptr``,
    ``tile_ptr``, ``ell_len``) are the port's own.
    """
    cached = getattr(program, "_device_ops_cache", None)
    if cached is not None:
        return cached
    S = program.plan.num_shards
    stages = program.stages
    policies = program.plan.resolved_shard_exchanges()
    use_a2a = any(e == "halo" for e in policies)
    lay = program.x_layout

    if use_a2a:
        send_idx, pos_map, H = _halo_tables(program)
    else:
        send_idx = np.zeros((S, 1, 1), dtype=np.int32)
        pos_map, H = None, 0

    def remap_rem(cols, vals, p):
        if not use_a2a:
            return cols.astype(np.int32)
        return _remap_cols(cols, vals, lay, p, pos_map[p])

    def remap_loc(cols, vals, p):
        out = lay.local_index(cols).astype(np.int32)
        return np.where(vals != 0, out, 0).astype(np.int32)

    R = int(max(_round_up(max(st.rows, 1), ELL_SUBLANE) for st in stages))
    flags = _row_remote_flags(program)
    row_remote = np.zeros((S, R), dtype=bool)
    loc_stages, rem_stages, loc_nnz, rem_nnz = [], [], [], []
    kid = np.zeros(S, dtype=np.int32)
    for p, st in enumerate(stages):
        kid[p] = PROGRAM_KERNELS.index(st.kernel)
        rr = flags[st.row_offset: st.row_offset + st.rows]
        row_remote[p, : st.rows] = rr
        sub = program.partition.shard_csr(program.matrix, p)
        loc_stages.append(_masked_stage(sub, ~rr, st))
        rem_stages.append(_masked_stage(sub, rr, st))
        per_row = csr_row_nnz(sub)
        loc_nnz.append(np.where(rr, 0, per_row))
        rem_nnz.append(np.where(rr, per_row, 0))
    loc = _stack_stages(loc_stages, R, remap_loc, loc_nnz)
    rem = _stack_stages(rem_stages, R, remap_rem, rem_nnz)
    cached = dict(kid=kid, send_idx=send_idx, row_remote=row_remote,
                  R=R, halo_H=H, NS_loc=loc.pop("NS"), NS_rem=rem.pop("NS"))
    cached.update({"loc_" + k: v for k, v in loc.items()})
    cached.update({"rem_" + k: v for k, v in rem.items()})
    program._device_ops_cache = cached
    return cached


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------------
# device executor
# --------------------------------------------------------------------------

def _exchange_index(program: SpmvProgram, ops: dict) -> np.ndarray:
    """(Sx, Lx) int64 positions into the flat (S * per) layout-order x that
    build the remote pass's buffers.  With a halo reader: row p is
    ``[x_local ++ recv]`` with ``recv[q] = x_shards[q, send_idx[q, p]]``
    (Sx = S).  For a uniform all-gather: the one global vector, undoing the
    cyclic layout's transpose (Sx = 1)."""
    S = program.plan.num_shards
    per = program.x_layout.padded_length() // S
    if any(e == "halo" for e in program.plan.resolved_shard_exchanges()):
        send = ops["send_idx"].astype(np.int64)          # (S, S, H)
        own = np.arange(S, dtype=np.int64)[:, None] * per
        recv = (own[:, :, None] + send).transpose(1, 0, 2).reshape(S, -1)
        return np.concatenate([own + np.arange(per), recv], axis=1)
    g = np.arange(S * per, dtype=np.int64)
    if program.x_layout.kind == "block":
        return g[None]
    return ((g % S) * per + g // S)[None]


def _tile_rows_used(tile_ptr: np.ndarray, sids: np.ndarray) -> int:
    """The block rows any tile of the shards ``sids`` reaches: the last
    block row with a tile, plus one (0 without tiles)."""
    rows = np.flatnonzero((np.diff(tile_ptr[sids], axis=1) > 0).any(axis=0))
    return int(rows[-1]) + 1 if rows.size else 0


def make_program_spmv_fn(program: SpmvProgram, *, device="cuda",
                         pipeline: bool = True):
    """The device executor: returns ``run(x_shards) -> y_shards``.

    ``x_shards`` is (S, per) or batched (S, per, B) in layout order (numpy
    or a tensor); ``y_shards`` is an (S, R[, B]) float32 tensor on
    ``device`` (slice each shard to its true row count, or use
    :func:`gather_b`).  Each call runs the local pass against ``x_local``
    and the remote pass against the exchange buffer, one launch per kernel
    family each, and keeps per row the pass that owns it.
    ``pipeline=True`` issues the local pass before the exchange gather,
    ``pipeline=False`` after it; the outputs are bitwise-equal.

    ``run.operands`` (the device operand tensors), ``run.families``
    (kernel -> int32 shard ids), ``run.rb_used`` (per pass, the block rows
    the tile shards' tiles reach) and ``run.buffers(x_shards)`` (the local
    and remote x buffers) let a caller replay single kernels.
    """
    dev = resolve_device(device)
    ops = _device_operands(program)
    S, R = program.plan.num_shards, ops["R"]
    per = program.x_layout.padded_length() // S
    T = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in ops.items() if isinstance(v, np.ndarray)}
    families = {name: torch.from_numpy(
                    np.flatnonzero(ops["kid"] == i).astype(np.int32)).to(dev)
                for i, name in enumerate(PROGRAM_KERNELS)
                if (ops["kid"] == i).any()}
    gidx = torch.from_numpy(_exchange_index(program, ops)).to(dev)
    row_remote = T["row_remote"][:, None, :]             # (S, 1, R)
    tile_sids = np.flatnonzero(ops["kid"] == PROGRAM_KERNELS.index("tile"))
    rb_used = {pre: _tile_rows_used(ops[pre + "tile_ptr"], tile_sids)
               for pre in ("loc_", "rem_")}

    def kernel_pass(pre: str, xbuf, num_splits: int):
        y = torch.empty((S, xbuf.shape[1], R), dtype=torch.float32,
                        device=dev)
        for name, sids in families.items():
            if name in ("ell", "hyb"):        # ell shards: empty ovf_ptr
                kops.hyb_stacked(T[pre + "ell_data"], T[pre + "ell_cols"],
                                 T[pre + "ovf_rows"], T[pre + "ovf_cols"],
                                 T[pre + "ovf_vals"], T[pre + "ovf_ptr"],
                                 xbuf, sids, ell_len=T[pre + "ell_len"],
                                 out=y)
            elif name == "seg":
                kops.seg_stacked(T[pre + "seg_vals"], T[pre + "seg_cols"],
                                 T[pre + "seg_pieces"], T[pre + "piece_ptr"],
                                 xbuf, sids, out=y)
            elif name == "split":
                kops.split_stacked(T[pre + "seg_vals"], T[pre + "seg_cols"],
                                   T[pre + "seg_pieces"],
                                   T[pre + "piece_ptr"], xbuf, sids,
                                   num_splits=num_splits, out=y)
            else:
                kops.tile_stacked(T[pre + "tile_data"], T[pre + "tile_xcol"],
                                  T[pre + "tile_brow"], T[pre + "tile_ptr"],
                                  xbuf, sids, rb_used=rb_used[pre], out=y)
        return y

    def local_buffer(x_shards):
        x = torch.as_tensor(x_shards, dtype=torch.float32, device=dev)
        if x.shape[:2] != (S, per) or x.dim() not in (2, 3):
            raise ValueError(f"x_shards must be ({S}, {per}[, B]), got "
                             f"{tuple(x.shape)}")
        xb = x if x.dim() == 3 else x[..., None]
        return xb.permute(0, 2, 1).contiguous(), x.dim() == 3   # (S, B, per)

    def exchange(xb):
        flat = xb.permute(1, 0, 2).reshape(xb.shape[1], S * per)
        return flat[:, gidx].permute(1, 0, 2).contiguous()      # (Sx, B, Lx)

    def run(x_shards):
        xb, batched = local_buffer(x_shards)
        if pipeline:
            y_loc = kernel_pass("loc_", xb, ops["NS_loc"])
            xg = exchange(xb)
        else:
            xg = exchange(xb)
            y_loc = kernel_pass("loc_", xb, ops["NS_loc"])
        y_rem = kernel_pass("rem_", xg, ops["NS_rem"])
        y = torch.where(row_remote, y_rem, y_loc).permute(0, 2, 1)
        return (y if batched else y[..., 0]).contiguous()

    def buffers(x_shards):
        xb, _ = local_buffer(x_shards)
        return xb, exchange(xb)

    run.rows_out = R
    run.operands = T
    run.families = families
    run.num_splits = {"loc_": ops["NS_loc"], "rem_": ops["NS_rem"]}
    run.rb_used = rb_used
    run.buffers = buffers
    return run


def gather_b(program: SpmvProgram, y_shards) -> np.ndarray:
    """(S, rows_pad[, B]) device output -> global b in the caller's order."""
    y = y_shards.cpu().numpy() if torch.is_tensor(y_shards) \
        else np.asarray(y_shards)
    out = np.zeros((program.matrix.nrows,) + y.shape[2:], dtype=y.dtype)
    for p, st in enumerate(program.stages):
        out[st.row_offset: st.row_offset + st.rows] = y[p, : st.rows]
    return out if program.perm is None else out[program.perm]


def probe_program(program: SpmvProgram, *, emu: EmuConfig | None = None,
                  engine: str = "vectorized") -> EmuResult:
    """Run the Emu timeline simulator on the program's (matrix, partition,
    layout) walk: the migratory-thread cost of the same plan the other
    backends execute (host, numpy or the compiled tick kernel)."""
    emu = emu or EmuConfig(nodelets=program.plan.num_shards)
    return run_spmv(program.matrix, program.partition, program.x_layout,
                    emu, engine=engine)


def execute(program: SpmvProgram, x: np.ndarray | None = None, *,
            backend: str = "numpy", device="cuda", pipeline: bool = True,
            emu: EmuConfig | None = None, engine: str = "vectorized"):
    """Execute a lowered program; returns y in the caller's order, (M,) or
    (M, B).

    * ``backend="numpy"``: the exact float64 host oracle.
    * ``backend="device"``: the executor of :func:`make_program_spmv_fn`
      on ``device`` (CUDA unless ``device="cpu"``), float32.
    * ``backend="emu"``: ignores ``x`` and returns the
      :class:`~repro_torch.core.emu.EmuResult` of :func:`probe_program`
      (``emu`` and ``engine`` go to it).
    """
    if backend == "emu":
        return probe_program(program, emu=emu, engine=engine)
    if x is None:
        raise ValueError(f"backend {backend!r} needs an input vector x")
    if backend == "numpy":
        return _execute_numpy(program, x)
    if backend == "device":
        fn = make_program_spmv_fn(program, device=device, pipeline=pipeline)
        xp = np.asarray(x, dtype=np.float32)
        if program.perm is not None:
            xp = _apply_perm(xp, program.perm)
        return gather_b(program, fn(program.x_to_device(xp)))
    raise ValueError(f"unknown executor backend {backend!r}; expected "
                     f"'numpy', 'device' or 'emu'")
