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
  :func:`make_program_spmv_fn` on one device, ``backend="shard_map"``
  the same executor over a mesh, ``backend="emu"`` the Emu timeline
  probe (:func:`probe_program`).

The device executor runs in one of two forms.  Without a mesh (or on a
local mesh of one device) it keeps all S shards on one device, and the
exchange prologue is one index gather that builds each shard's
``[x_local ++ recv]`` buffer (or the one global vector of a uniform
all-gather program).  On a ``torch.distributed`` mesh
(:mod:`repro_torch.launch.mesh`) each of the W ranks along the axis
holds a block of S/W shards, and the exchange is a real collective, as
the reference's ``shard_map`` executor's: one ``all_to_all_single`` of
the packed halo when any shard reads a halo, one all-gather of the
shards otherwise.  In both forms each kernel family is one launch over
its shards' stacked operands, and, as in the reference, a local pass
(rows that read only the shard's own x) and a remote pass (rows that
wait for the exchange) are combined per row.  No kernel uses atomics and
no shard's result depends on which shards share its launch, so the
result is bitwise-deterministic: ``pipeline=True`` and ``False`` agree
bitwise, column b of an (N, B) call equals the per-vector call on
``x[:, b]``, and every world size gives the one-device executor's y.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import numpy as np
import torch

from .. import tracing
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
from ..kernels.exchange import gather_rows
from ..kernels.ops import resolve_device

__all__ = ["ShardStage", "SpmvProgram", "lower", "relower",
           "program_from_arrays", "resolve_device", "execute",
           "make_program_spmv_fn", "device_spmv", "probe_program",
           "gather_b", "PROGRAM_KERNELS", "MAX_GRAPHS"]

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


def _split_count(sub: CSRMatrix, requested: int) -> int:
    """The split count a shard's rows ``sub`` lower with: the request (or
    the :func:`split_meta` policy when it is 0), clamped to [1, their
    chunk count]."""
    ns = requested if requested > 0 else \
        split_meta(sub.nnz, int(csr_row_nnz(sub).max(initial=0)))
    C = max(-(-sub.nnz // _round_up(kops.SEG_CHUNK, ELL_LANE)), 1)
    return max(1, min(int(ns), C))


def _stage_from_csr(sub: CSRMatrix, kernel: str, num_splits: int,
                    shard: int, row_offset: int) -> ShardStage:
    """Lower shard ``shard``'s rows ``sub`` (all its rows, or one pass's
    slice with the other rows emptied) into ``kernel``'s family; a split
    stage takes :func:`_split_count` of ``num_splits``."""
    ell = seg = split = tile = None
    if kernel == "ell":
        ell = csr_to_ell(sub)
    elif kernel == "hyb":
        ell = kops.hyb_from_csr(sub)
    elif kernel == "seg":
        seg = kops.seg_from_csr(sub)
    elif kernel == "split":
        split = kops.split_from_csr(sub, _split_count(sub, num_splits))
    elif kernel == "tile":
        tile = kops.tile_from_csr(sub)
    else:
        raise ValueError(f"unknown shard kernel {kernel!r}; expected one of "
                         f"{PROGRAM_KERNELS}")
    return ShardStage(shard=shard, kernel=kernel, rows=sub.nrows,
                      row_offset=row_offset, nnz=sub.nnz, ell=ell, seg=seg,
                      split=split, tile=tile)


def _build_stage(A: CSRMatrix, part: Partition, p: int,
                 kernel: str, split_count: int = 0) -> ShardStage:
    return _stage_from_csr(part.shard_csr(A, p), kernel, split_count, p,
                           int(part.starts[p]))


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

    # -- legacy stacked-slab views (deprecated; read ``stages`` instead).
    # Host numpy, bitwise the reference's; the executor does not use them.

    @property
    def data(self) -> np.ndarray:
        """(S, rows_pad, W) stacked *uncapped* ELL slabs (legacy view)."""
        return self._ell_stack()[0]

    @property
    def cols(self) -> np.ndarray:
        """(S, rows_pad, W) stacked global ELL column ids (legacy view)."""
        return self._ell_stack()[1]

    def _ell_stack(self):
        cached = getattr(self, "_ell_stack_cache", None)
        if cached is not None:
            return cached
        slabs = []
        for st in self.stages:
            if st.kernel == "ell":
                slabs.append(st.ell)
            else:
                sub = self.matrix.row_slice(st.row_offset,
                                            st.row_offset + st.rows)
                slabs.append(csr_to_ell(sub))
        rows_pad = max(s.data.shape[0] for s in slabs)
        width = max(s.width for s in slabs)
        S = self.plan.num_shards
        data = np.zeros((S, rows_pad, width), dtype=np.float32)
        cols = np.zeros((S, rows_pad, width), dtype=np.int32)
        for p, s in enumerate(slabs):
            r, w = s.data.shape
            data[p, :r, :w] = s.data
            cols[p, :r, :w] = s.cols
        self._ell_stack_cache = (data, cols)
        return self._ell_stack_cache

    @property
    def seg_vals(self):
        s = self._seg_stack()
        return None if s is None else s["seg_vals"]

    @property
    def seg_cols(self):
        s = self._seg_stack()
        return None if s is None else s["seg_cols"]

    @property
    def seg_rows(self):
        s = self._seg_stack()
        return None if s is None else s["seg_rows"]

    @property
    def seg_pieces(self):
        s = self._seg_stack()
        return None if s is None else s["seg_pieces"]

    def _seg_stack(self):
        """Legacy stacked seg slabs (dummy-row piece padding), uniform-seg
        programs only, as the pre-IR ``build_distributed`` built them."""
        if any(st.kernel != "seg" for st in self.stages):
            return None
        cached = getattr(self, "_seg_stack_cache", None)
        if cached is None:
            cached = _stack_seg_legacy([st.seg for st in self.stages],
                                       self.rows_per_shard)
            self._seg_stack_cache = cached
        return cached


def _stack_seg_legacy(segs, rows_per_shard) -> dict:
    """Stacked per-shard SegMatrix slabs, padded to common shapes.

    Column ids stay global (the allgather path gathers the full x); row ids
    are shard-local.  Piece padding targets the per-shard dummy row
    (``rows_pad``) with (lo=1, hi=0) so ``psum[c, hi] - psum[c, lo-1]``
    evaluates to an exact zero for padded entries.
    """
    S = len(segs)
    C_pad = max(s.num_chunks for s in segs)
    L = segs[0].chunk
    P_pad = max(max(s.n_pieces for s in segs), 1)
    rows_pad = int(np.asarray(rows_per_shard).max())
    vals = np.zeros((S, C_pad, L), dtype=np.float32)
    cols = np.zeros((S, C_pad, L), dtype=np.int32)
    rows = np.zeros((S, C_pad, L), dtype=np.int32)
    pieces = np.zeros((S, P_pad, 4), dtype=np.int32)
    pieces[:, :, 1] = 1                       # (lo=1, hi=0) -> exact zero
    pieces[:, :, 3] = rows_pad                # dummy row, sliced off later
    for p, s in enumerate(segs):
        vals[p, : s.num_chunks] = s.vals
        cols[p, : s.num_chunks] = s.cols
        rows[p, : s.num_chunks] = s.rows
        n = s.n_pieces
        pieces[p, :n, 0] = s.piece_chunk
        pieces[p, :n, 1] = s.piece_lo
        pieces[p, :n, 2] = s.piece_hi
        pieces[p, :n, 3] = s.piece_row
    return dict(seg_vals=vals, seg_cols=cols, seg_rows=rows,
                seg_pieces=pieces)


# --------------------------------------------------------------------------
# lowering
# --------------------------------------------------------------------------

def program_from_arrays(*, shape, values, col_index, row_ptr, starts, plan,
                        perm=None) -> SpmvProgram:
    """Build the program from host arrays: the (already reordered) CSR
    matrix, the partition's row starts, the plan (an :class:`SpmvPlan` or
    a dict of its fields) and the reordering ``perm`` (or None).

    This is how a program lowered elsewhere (the JAX reference) is carried
    over: its arrays in, the same stages out.  Records the spans
    ``lower.stages`` and ``lower.emu_accounting``.
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
    with tracing.span("lower.stages"):
        x_layout = make_layout(plan.layout, A.ncols, plan.num_shards)
        b_layout = make_layout(plan.layout, A.nrows, plan.num_shards)
        kernels = plan.resolved_shard_kernels()
        split_counts = plan.resolved_split_counts()
        stages = tuple(_build_stage(A, part, p, kernels[p], split_counts[p])
                       for p in range(plan.num_shards))
    with tracing.span("lower.emu_accounting"):
        traffic = count_migrations(A, part, x_layout, b_layout)
        shard_traffic = remote_access_matrix(A, part, x_layout)
    return SpmvProgram(
        plan=plan, matrix=A, partition=part, x_layout=x_layout,
        b_layout=b_layout,
        rows_per_shard=part.rows_per_shard().astype(np.int64),
        row_offset=part.starts[:-1].astype(np.int64),
        traffic=traffic, shard_traffic=shard_traffic,
        stages=stages, perm=None if perm is None else np.asarray(perm))


def lower(csr: CSRMatrix, plan: SpmvPlan) -> SpmvProgram:
    """Lower (matrix, plan) to a per-shard-staged :class:`SpmvProgram`.

    Records the span ``lower`` over ``lower.reorder`` (entered whatever
    the reordering), ``lower.stages`` (the partition, the layouts and the
    stages) and ``lower.emu_accounting`` (:mod:`repro_torch.tracing`)."""
    if csr.nrows != csr.ncols:
        raise ValueError("paper applies symmetric reorderings to square "
                         "matrices")
    with tracing.span("lower"):
        perm = None
        A = csr
        with tracing.span("lower.reorder"):
            if plan.reordering != "none":
                perm = reordering_permutation(csr, plan.reordering,
                                              seed=plan.seed,
                                              parts=plan.num_shards)
                A = csr.permuted(perm, perm)
        with tracing.span("lower.stages"):
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
        want = _split_count(program.partition.shard_csr(program.matrix, p),
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


def _check_x(program: SpmvProgram, x: np.ndarray) -> None:
    if x.shape[0] != program.matrix.ncols:
        raise ValueError(f"x has {x.shape[0]} elements, matrix expects "
                         f"{program.matrix.ncols}")
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be (N,) or (N, B), got shape {x.shape}")


def _execute_numpy(program: SpmvProgram, x: np.ndarray) -> np.ndarray:
    """y = A @ x on the host, caller index order, float64; ``x`` is (N,) or
    (N, B).  Batch-major, so column b equals the per-vector call bitwise."""
    _check_x(program, x)
    if x.ndim == 1:
        return _execute_numpy_block(program, x[:, None])[:, 0]
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
    over the tiles' block rows; ``seg_chunk_ptr`` (S, C+1) gives a seg
    shard's pieces by chunk (row order is chunk order there; 0 for other
    families), for the seg family's scan.  ``ell_len`` (S, R) counts each
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
    seg_chunk_ptr = np.zeros((S, C + 1), dtype=np.int32)
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
            seg_chunk_ptr[p] = _row_ranges(s.piece_chunk, C)
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
                seg_chunk_ptr=seg_chunk_ptr,
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
    ``seg_chunk_ptr``, ``tile_ptr``, ``ell_len``) are the port's own.

    Every array is stacked over all S shards (first dimension S), also
    on a rank of a mesh: as the reference builds its global operands
    before ``shard_map`` shards them, each rank builds them whole on the
    host; the executor uploads only its block of shards of the arrays its
    kernel families read (``_FAMILIES``).
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
        ns = st.split.num_splits if st.split is not None else 0
        loc_stages.append(_stage_from_csr(_row_masked_csr(sub, ~rr),
                                          st.kernel, ns, p, st.row_offset))
        rem_stages.append(_stage_from_csr(_row_masked_csr(sub, rr),
                                          st.kernel, ns, p, st.row_offset))
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

#: The executor's kernel families, by shard kernel: the operand keys a
#: family's launch reads from a pass (without the pass's ``loc_``/``rem_``
#: prefix), which are all the executor uploads for it, and the launch,
#: ``launch(operands, x, sids, y, num_splits, rb_used)``, taking those
#: operands in that order.  ``ell`` shards run ``hyb_stacked`` with an
#: empty overflow.
_Family = collections.namedtuple("_Family", "keys launch")
_ELL = _Family(("ell_data", "ell_cols", "ovf_rows", "ovf_cols", "ovf_vals",
                "ovf_ptr", "ell_len"),
               lambda o, x, sids, y, ns, rb: kops.hyb_stacked(
                   *o[:6], x, sids, ell_len=o[6], out=y))
_FAMILIES = {
    "ell": _ELL, "hyb": _ELL,
    "seg": _Family(("seg_vals", "seg_cols", "seg_pieces", "piece_ptr",
                    "seg_chunk_ptr"),
                   lambda o, x, sids, y, ns, rb: kops.seg_stacked(
                       *o[:4], x, sids, chunk_ptr=o[4], out=y)),
    "split": _Family(("seg_vals", "seg_cols", "seg_pieces", "piece_ptr"),
                     lambda o, x, sids, y, ns, rb: kops.split_stacked(
                         *o, x, sids, num_splits=ns, out=y)),
    "tile": _Family(("tile_data", "tile_xcol", "tile_brow", "tile_ptr"),
                    lambda o, x, sids, y, ns, rb: kops.tile_stacked(
                        *o, x, sids, rb_used=rb, out=y)),
}


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


def _placement(program: SpmvProgram, mesh, axis: str, device):
    """Where the executor runs: ``(device, group, block, W)``, the process
    group over ``axis`` (None off a distributed mesh), this rank's
    coordinate along it and the axis's size."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device), \
            None, 0, 1
    if mesh.abstract:
        raise ValueError("an abstract mesh has no devices to run on")
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's axes "
                         f"{mesh.axis_names}")
    dev = mesh.local_device
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's device {dev}")
    if not mesh.distributed:
        if mesh.size > 1:
            raise ValueError(
                f"a local mesh of {mesh.size} devices: start one process "
                f"per device on a torch.distributed group (torchrun)")
        return resolve_device(dev), None, 0, 1
    import torch.distributed as dist
    S, W = program.plan.num_shards, mesh.shape[axis]
    if S % W:
        raise ValueError(f"{S} shards do not split over {W} ranks along "
                         f"{axis!r}: the ranks must divide the shards")
    group = mesh.group((axis,))
    want = "nccl" if dev.type == "cuda" else "gloo"
    backend = dist.get_backend(group)
    if backend != want:
        raise ValueError(f"a {dev.type} executor needs a {want} group; the "
                         f"mesh's {axis!r} group is {backend}")
    return resolve_device(dev), group, mesh.coordinate(axis), W


def _all_gather(out, x, group, async_op: bool = False):
    import torch.distributed as dist
    # all_gather_single is all_gather_into_tensor's newer name
    return getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x, group=group, async_op=async_op)


@contextlib.contextmanager
def _upload(dev):
    """The span ``executor.upload`` around host-to-device copies, ended
    when they are done, so that none spills into a later span."""
    with tracing.span("executor.upload"):
        yield
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


def _index_exchange(program: SpmvProgram, ops: dict, dev):
    """The one-device exchange: the remote pass's buffers by one gather of
    whole rows of the flat layout-order x (:func:`_exchange_index`), an
    element's B columns a row."""
    S = program.plan.num_shards
    per = program.x_layout.padded_length() // S
    with tracing.span("executor.operands"):
        index = _exchange_index(program, ops)
    with _upload(dev):
        gidx = torch.from_numpy(index).to(dev)

    def start(xb):
        def finish():                                         # (Sx, Lx, B)
            return gather_rows(xb.reshape(S * per, xb.shape[2]), gidx)
        return finish
    return start


def _halo_exchange(ops: dict, lo: int, hi: int, per: int, W: int, group,
                   dev):
    """The halo exchange of the shards [lo, hi) as one all-to-all.

    Each rank packs, for every reader p of the S and each of its own
    shards q, the rows ``send_idx[q, p]`` of q's ``x_local``, laid out by
    the reader's rank; what comes back is each local reader's ``recv``,
    ordered by global source shard and padded to H, so its buffer
    ``[x_local ++ recv]`` is the one-device executor's, row for row."""
    import torch.distributed as dist
    n = hi - lo
    send = ops["send_idx"][lo:hi].astype(np.int64)            # (n, S, H)
    S, H = send.shape[1], send.shape[2]
    with tracing.span("executor.operands"):
        index = np.ascontiguousarray(
            (np.arange(n)[:, None, None] * per + send).transpose(1, 0, 2))
    with _upload(dev):
        pack = torch.from_numpy(index).to(dev)               # (S, n, H)

    def start(xb):
        B = xb.shape[2]
        to_send = gather_rows(xb.reshape(n * per, B), pack)  # (S, n, H, B)
        recv = torch.empty_like(to_send)                  # (W * n, n, H, B)
        work = dist.all_to_all_single(recv, to_send, group=group,
                                      async_op=True)

        def finish():
            work.wait()
            got = recv.view(W, n, n * H, B).transpose(0, 1)  # by source rank
            return torch.cat([xb, got.reshape(n, S * H, B)], dim=1)
        return finish
    return start


def _gather_exchange(kind: str, S: int, per: int, group):
    """The uniform all-gather: every rank's (S/W, per, B) block gathered
    into the (S, per, B) shards, then laid out as the one global vector
    (a view for ``block``, the transpose for ``cyclic``)."""

    def start(xb):
        B = xb.shape[2]
        xs = torch.empty((S, per, B), dtype=xb.dtype, device=xb.device)
        work = _all_gather(xs, xb, group, async_op=True)

        def finish():
            work.wait()
            g = xs if kind == "block" else xs.transpose(0, 1)
            return g.reshape(1, S * per, B).contiguous()
        return finish
    return start


def make_program_spmv_fn(program: SpmvProgram, mesh=None,
                         axis: str = "model", *, device=None,
                         pipeline: bool = True, graphs: bool = False):
    """The device executor: returns ``run(x_shards) -> y_shards``.

    ``x_shards`` is (S, per) or batched (S, per, B) in layout order (numpy
    or a tensor); ``y_shards`` is an (S, R[, B]) float32 tensor on the
    executor's device (slice each shard to its true row count, or use
    :func:`gather_b`).  Each call runs the local pass against ``x_local``
    and the remote pass against the exchange buffer, one launch per kernel
    family each, and keeps per row the pass that owns it.
    ``pipeline=True`` issues the local pass before the exchange completes,
    ``pipeline=False`` after it; the outputs are bitwise-equal.

    Without ``mesh`` (or on a local mesh of one device) the executor runs
    on ``device`` (CUDA unless ``device="cpu"``) and holds all S shards.
    On a distributed mesh (:mod:`repro_torch.launch.mesh`; every rank
    calls this, and every call of ``run``) rank r of the W along ``axis``
    holds the shards ``[r S/W, (r+1) S/W)`` on its own device: it uploads
    only that block of its operands, ``run`` takes the global x_shards
    and returns this rank's (S/W, R[, B]) block, and the exchange is one
    collective on the axis's group (the halo's ``all_to_all_single``, or
    the all-gather of the shards), issued asynchronously so that with
    ``pipeline=True`` the local pass runs while it is in flight.  W must
    divide S, and the group's backend must be the device's (NCCL for
    CUDA, gloo for the CPU); a local mesh of more than one device raises.

    ``graphs=True`` (CUDA only, one device; it raises on another device
    and on a distributed mesh) makes the executor reusable at the card's
    own speed, as ``jax.jit`` makes the reference's: the first call for
    each x shape, (S, per) or (S, per, B), captures the call as one CUDA
    graph over a static x buffer, and every call copies x in, replays the
    graph and returns a copy of its output, bitwise the eager call's.
    Calls from several threads take turns on one lock; at most
    :data:`MAX_GRAPHS` shapes are held, the least recently used dropped
    first.  ``run.graph_stats()`` lists each held shape's capture seconds
    (warm-up call included), the device memory it holds (what its graph
    pool reserved during the capture, plus the static x) and its replays;
    ``run.prime(shapes)`` captures shapes ahead of their first call (both
    are no-ops without graphs).  Launch counts (``_lib.launch_counts``)
    grow at the warm-up call and the capture, not at replays.

    ``run.operands`` (the device operand tensors: ``row_remote`` and,
    for each pass, the ``loc_``/``rem_`` operands the launches of the
    block's kernel families read, and nothing else), ``run.families``
    (kernel -> int32 shard ids within the block), ``run.rb_used`` (per
    pass, the block rows the tile shards' tiles reach), ``run.shards``
    (the block's first and end shard) and ``run.buffers(x_shards)`` (the
    local and remote x buffers, batch-minor: (S/W, per, B) and (Sx, Lx,
    B), an element's B columns one row) let a caller replay single
    kernels.

    The build records the span ``executor.build`` over
    ``executor.operands`` (the host operands and the exchange's index)
    and ``executor.upload`` (their copies to the device), and each
    capture ``executor.capture`` (:mod:`repro_torch.tracing`).  While
    ``tracing.recording()`` is true, each call records the span
    ``spmv.call`` and counts ``spmv.calls``, where it found all earlier
    work of this executor done (on the CPU: always) ``spmv.starved``,
    and, with split, tile or ELL shards, those families' counters (a
    graph replay as the eager call; :func:`_family_counters`).
    """
    with tracing.span("executor.build"):
        return _build_executor(program, mesh, axis, device, pipeline, graphs)


def _build_executor(program, mesh, axis, device, pipeline, graphs):
    dev, group, block, W = _placement(program, mesh, axis, device)
    if graphs and (group is not None or dev.type != "cuda"):
        where = "a distributed mesh's collectives are not captured" \
            if group is not None else f"device {dev} has none"
        raise ValueError(f"graphs=True replays one device's CUDA graphs; "
                         f"{where} (use graphs=False)")
    with tracing.span("executor.operands"):
        ops = _device_operands(program)
    S, R = program.plan.num_shards, ops["R"]
    per = program.x_layout.padded_length() // S
    n = S // W
    lo, hi = block * n, (block + 1) * n
    kid = ops["kid"][lo:hi]
    with _upload(dev):
        families = {name: torch.from_numpy(
                        np.flatnonzero(kid == i).astype(np.int32)).to(dev)
                    for i, name in enumerate(PROGRAM_KERNELS)
                    if (kid == i).any()}
        read = dict.fromkeys(pre + k for pre in ("loc_", "rem_")
                             for name in families
                             for k in _FAMILIES[name].keys)
        T = {k: torch.from_numpy(np.ascontiguousarray(ops[k][lo:hi])).to(dev)
             for k in ["row_remote", *read]}
    if group is None:
        start_exchange = _index_exchange(program, ops, dev)
    elif any(e == "halo" for e in program.plan.resolved_shard_exchanges()):
        start_exchange = _halo_exchange(ops, lo, hi, per, W, group, dev)
    else:
        start_exchange = _gather_exchange(program.x_layout.kind, S, per,
                                          group)
    row_remote = T["row_remote"][:, None, :]             # (n, 1, R)
    tile_sids = np.flatnonzero(kid == PROGRAM_KERNELS.index("tile"))
    rb_used = {pre: _tile_rows_used(ops[pre + "tile_ptr"][lo:hi], tile_sids)
               for pre in ("loc_", "rem_")}
    num_splits = {"loc_": ops["NS_loc"], "rem_": ops["NS_rem"]}
    counts = _family_counters(program, ops, T, families, lo)

    def kernel_pass(pre: str, xbuf):
        y = torch.empty((n, xbuf.shape[2], R), dtype=torch.float32,
                        device=dev)
        for name, sids in families.items():
            fam = _FAMILIES[name]
            fam.launch([T[pre + k] for k in fam.keys], xbuf, sids, y,
                       num_splits[pre], rb_used[pre])
        return y

    def local_buffer(x_shards):
        _check_shards(x_shards, S, per)
        x = torch.as_tensor(x_shards[lo:hi], dtype=torch.float32, device=dev)
        xb = x if x.dim() == 3 else x[..., None]
        return xb.contiguous(), x.dim() == 3                   # (n, per, B)

    def eager(x_shards):
        xb, batched = local_buffer(x_shards)
        finish = start_exchange(xb)
        if pipeline:
            y_loc = kernel_pass("loc_", xb)
            xg = finish()
        else:
            xg = finish()
            y_loc = kernel_pass("loc_", xb)
        y_rem = kernel_pass("rem_", xg)
        y = torch.where(row_remote, y_rem, y_loc).permute(0, 2, 1)
        return (y if batched else y[..., 0]).contiguous()

    def buffers(x_shards):
        xb, _ = local_buffer(x_shards)
        return xb, start_exchange(xb)()

    if graphs:
        run = _graphed(eager, dev, S, per, counts)
    else:                                     # nothing to capture
        run = _traced(eager, dev, counts)
        run.prime = lambda shapes: None
        run.graph_stats = lambda: []
    run.program = program
    run.mesh = mesh if group is not None else None   # what gather_b needs
    run.axis = axis
    run.shards = (lo, hi)
    run.rows_out = R
    run.operands = T
    run.families = families
    run.num_splits = num_splits
    run.rb_used = rb_used
    run.buffers = buffers
    return run


#: The kernel families whose shards a recorded call counts, read by the
#: benchmark's ``split_kb``, ``split_roofline``, ``tile_roofline`` and
#: ``ell_roofline``.
_COUNTED_FAMILIES = ("split", "tile", "ell")


def _family_counters(program: SpmvProgram, ops: dict, T: dict,
                     families: dict, lo: int):
    """``counts(B)``: what a recorded call of B columns adds to the
    counters of each family of :data:`_COUNTED_FAMILIES` that the block
    runs, fixed when the executor is built: ``<family>.nnz`` and
    ``<family>.rows`` (its shards', in both passes together),
    ``<family>.x_elems`` (the distinct columns they read, times B) and
    ``<family>.y_elems`` (their rows, times B); besides, ``tile.tiles``
    (the tile stages' tiles), ``split.scratch_bytes`` (the device
    scratch the split family's two passes allocate,
    :func:`kops.split_scratch_bytes`) and ``split.long_rows``,
    ``split.long_pieces`` and ``split.long_runs`` (what the split
    fix-up's long-row path takes in both passes, from the host piece
    tables ``ops``: :func:`kops.split_long_rows`).  Nothing without such
    shards."""
    A = program.matrix
    fixed, per_column = {}, {}
    for name in _COUNTED_FAMILIES:
        sids = families.get(name)
        if sids is None:
            continue
        stages = [program.stages[lo + k] for k in sids.tolist()]
        read = np.zeros(A.ncols, dtype=bool)
        for st in stages:
            read[A.col_index[A.row_ptr[st.row_offset]:
                             A.row_ptr[st.row_offset + st.rows]]] = True
        rows = sum(st.rows for st in stages)
        fixed[name + ".nnz"] = sum(st.nnz for st in stages)
        fixed[name + ".rows"] = rows
        per_column[name + ".x_elems"] = int(read.sum())
        per_column[name + ".y_elems"] = rows
        if name == "tile":
            fixed["tile.tiles"] = sum(st.tile.num_tiles for st in stages)
        if name == "split":
            per_column["split.scratch_bytes"] = sum(
                kops.split_scratch_bytes(T[pre + "seg_vals"], len(stages), 1)
                for pre in ("loc_", "rem_"))
            shards = lo + sids.cpu().numpy()
            for pre in ("loc_", "rem_"):
                for key, v in kops.split_long_rows(
                        ops[pre + "seg_pieces"][shards],
                        ops[pre + "piece_ptr"][shards],
                        ops["NS_" + pre[:-1]]).items():
                    fixed["split." + key] = fixed.get("split." + key, 0) + v
    if not fixed:
        return _no_counters

    def counts(B: int) -> dict:
        return {**fixed, **{k: v * B for k, v in per_column.items()}}
    return counts


def _no_counters(B: int) -> dict:
    return {}


def _columns(x) -> int:
    """B of an (S, per, B) x; 1 of an (S, per) x."""
    return x.shape[2] if len(x.shape) == 3 else 1


def _check_shards(x, S: int, per: int) -> None:
    if tuple(x.shape[:2]) != (S, per) or len(x.shape) not in (2, 3):
        raise ValueError(f"x_shards must be ({S}, {per}[, B]), got "
                         f"{tuple(x.shape)}")


#: The most x shapes one graphed executor holds captured.  The router's
#: micro-batches give at most ``max_batch`` shapes per tenant, plus the
#: caller's own blocks.
MAX_GRAPHS = 16


def _traced(eager, dev, counts=_no_counters):
    """``eager`` with the per-call span and counters (``counts(B)``: the
    per-shape ones).  On CUDA a call starved the device where the event
    recorded at the end of this executor's last recorded call has
    completed."""
    state = {"done": None}

    def run(x_shards):
        if not tracing.recording():
            return eager(x_shards)
        with tracing.call_span("spmv.call"):
            done = state["done"]
            _count_call(done is None or done.query(),
                        counts(_columns(x_shards)))
            y = eager(x_shards)
            if dev.type == "cuda":
                state["done"] = torch.cuda.current_stream(dev).record_event()
        return y
    return run


def _count_call(starved: bool, per_shape: dict) -> None:
    tracing.count("spmv.calls")
    if starved:
        tracing.count("spmv.starved")
    for name, n in per_shape.items():
        tracing.count(name, n)


def _graphed(eager, dev, S: int, per: int, counts=_no_counters):
    """``eager`` behind a cache of CUDA graphs, one per x shape; a replay
    counts what a call of its shape counts (``counts(B)``), as the eager
    call would."""
    lock = threading.Lock()
    held = collections.OrderedDict()      # shape -> (graph, x, y, stats)
    state = {"stream": None, "done": None}

    def capture(shape):
        # Each executor captures on its own stream, so a re-plan thread and
        # a request thread can capture at the same time; thread-local mode
        # lets other threads launch and allocate meanwhile.  A warm-up
        # call first loads every kernel outside the capture.
        if state["stream"] is None:
            state["stream"] = torch.cuda.Stream(dev)
        side = state["stream"]
        x = torch.zeros(shape, dtype=torch.float32, device=dev)
        with tracing.span("executor.capture") as sp:
            side.wait_stream(torch.cuda.current_stream(dev))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                eager(x)
                reserved = torch.cuda.memory_reserved(dev)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    y = eager(x)
                except BaseException:
                    with contextlib.suppress(RuntimeError):  # keep the cause
                        graph.capture_end()
                    raise
                graph.capture_end()
                reserved = torch.cuda.memory_reserved(dev) - reserved
            torch.cuda.current_stream(dev).wait_stream(side)
        held[shape] = (graph, x, y, dict(
            shape=list(shape), capture_s=sp.seconds,
            bytes=int(reserved) + x.numel() * x.element_size(), replays=0))
        while len(held) > MAX_GRAPHS:
            held.popitem(last=False)
        return held[shape]

    def entry(shape):
        if shape in held:
            held.move_to_end(shape)
            return held[shape]
        return capture(shape)

    def run(x_shards):
        if not tracing.recording():
            return replay(x_shards, False)
        with tracing.call_span("spmv.call"):
            return replay(x_shards, True)

    def replay(x_shards, traced: bool):
        x = torch.as_tensor(x_shards, dtype=torch.float32)
        _check_shards(x, S, per)
        stream = torch.cuda.current_stream(dev)
        with lock:
            if traced:                # before this call enqueues anything
                _count_call(state["done"] is None or state["done"].query(),
                            counts(_columns(x)))
            graph, x_static, y_static, stats = entry(tuple(x.shape))
            if state["done"] is not None:       # a caller on another stream
                stream.wait_event(state["done"])
            x_static.copy_(x)
            graph.replay()
            y = y_static.clone()
            state["done"] = stream.record_event()
            stats["replays"] += 1
        return y

    def prime(shapes):
        with lock:
            for shape in shapes:
                entry(tuple(shape))

    def graph_stats():
        with lock:
            return [dict(st) for _, _, _, st in held.values()]

    run.prime = prime
    run.graph_stats = graph_stats
    return run


def gather_b(program: SpmvProgram, y_shards, mesh=None,
             axis: str = "model") -> np.ndarray:
    """(S, rows_pad[, B]) device output -> global b in the caller's order.

    On a distributed ``mesh``, ``y_shards`` is this rank's block of
    shards (what the executor over that mesh returns) and the blocks are
    gathered first, with one all-gather on the group over ``axis``: a
    collective, so every rank calls it, and every rank gets the whole
    b."""
    if mesh is not None and mesh.distributed:
        part = torch.as_tensor(y_shards).contiguous()
        y_shards = part.new_empty((program.plan.num_shards,)
                                  + tuple(part.shape[1:]))
        _all_gather(y_shards, part, mesh.group((axis,)))
    y = y_shards.cpu().numpy() if torch.is_tensor(y_shards) \
        else np.asarray(y_shards)
    out = np.zeros((program.matrix.nrows,) + y.shape[2:], dtype=y.dtype)
    for p, st in enumerate(program.stages):
        out[st.row_offset: st.row_offset + st.rows] = y[p, : st.rows]
    return out if program.perm is None else out[program.perm]


def device_spmv(run, x: np.ndarray) -> np.ndarray:
    """y = A @ x through ``run``, an executor of
    :func:`make_program_spmv_fn`: ``x`` (N,) or (N, B) in the caller's
    order in, float32 numpy (M,) or (M, B) in the caller's order out.
    Over a distributed mesh every rank calls it and gets the whole y."""
    program = run.program
    x = np.asarray(x)
    _check_x(program, x)
    xp = x.astype(np.float32)
    if program.perm is not None:
        xp = _apply_perm(xp, program.perm)
    return gather_b(program, run(program.x_to_device(xp)), run.mesh,
                    run.axis)


def probe_program(program: SpmvProgram, *, emu: EmuConfig | None = None,
                  engine: str = "vectorized") -> EmuResult:
    """Run the Emu timeline simulator on the program's (matrix, partition,
    layout) walk: the migratory-thread cost of the same plan the other
    backends execute (host, numpy or the compiled tick kernel)."""
    emu = emu or EmuConfig(nodelets=program.plan.num_shards)
    return run_spmv(program.matrix, program.partition, program.x_layout,
                    emu, engine=engine)


def execute(program: SpmvProgram, x: np.ndarray | None = None, *,
            backend: str = "numpy", device="cuda", mesh=None,
            axis: str = "model", pipeline: bool = True,
            emu: EmuConfig | None = None, engine: str = "vectorized"):
    """Execute a lowered program; returns y in the caller's order, (M,) or
    (M, B).

    * ``backend="numpy"``: the exact float64 host oracle.
    * ``backend="device"``: the executor of :func:`make_program_spmv_fn`
      on ``device`` (CUDA unless ``device="cpu"``), float32.
    * ``backend="shard_map"``: the same executor over ``mesh`` along
      ``axis``, as the reference's entry point of that name; on a
      distributed mesh every rank calls it and every rank gets y.
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
        return device_spmv(make_program_spmv_fn(program, device=device,
                                                pipeline=pipeline), x)
    if backend == "shard_map":
        if mesh is None:
            raise ValueError("backend='shard_map' needs a mesh "
                             "(repro_torch.launch.mesh); backend='device' "
                             "runs on one device")
        return device_spmv(make_program_spmv_fn(program, mesh, axis,
                                                pipeline=pipeline), x)
    raise ValueError(f"unknown executor backend {backend!r}; expected "
                     f"'numpy', 'device', 'shard_map' or 'emu'")
