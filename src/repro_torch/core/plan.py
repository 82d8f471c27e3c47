"""Cost-model-driven SpMV plan autotuner (the paper's study as policy).

The paper's core result is a *cost-benefit study*: no single layout /
work-distribution / reordering wins on a migratory-thread machine — the
right choice depends on sparsity structure (reordering buys up to 70% on
Emu vs <= 16% on a cache machine, §IV-E; the nonzero split only pays on
skewed matrices, §IV-C).  This module turns that study into an executable
policy, in the spirit of feature-based SpMV optimization selection
(Elafrou et al., 2017):

1. :func:`extract_features` — structural features of a
   :class:`~repro_torch.core.sparse_matrix.CSRMatrix` (row-nnz CV, bandwidth,
   power-law tail share, hot-column share via
   :func:`~repro_torch.core.migration.remote_access_matrix`).
2. :func:`estimate_cost` — an analytic cost model for one
   :class:`~repro_torch.core.spmv.SpmvPlan`, grounded in the Emu machine
   constants (:class:`~repro_torch.core.emu.EmuConfig`) and the exact migration
   counts of :mod:`repro_torch.core.migration`; device-side terms (ELL
   padding, collective volume; weights set for the reference's TPU
   kernels) follow :mod:`repro_torch.core.cache_model`'s style of
   analytic accounting.
3. :func:`autotune` — score the full candidate grid, refine the top
   candidates with a short empirical probe (the vectorized Emu timeline
   simulator, :func:`~repro_torch.core.emu.run_spmv`; on by default, see
   :data:`DEFAULT_PROBE`), and return a ranked, JSON-serializable
   :class:`PlanChoice`.

``SpmvPlan.auto(csr)`` (in :mod:`repro_torch.core.spmv`) is the one-call
entry point; the reference's ``serve.engine.SparseMatrixEngine`` applies
it to every ingested matrix at load time.

The port's host copy of ``repro.core.plan`` (numpy only): the same
arithmetic, so its results equal the reference's bitwise.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from typing import Iterable, Sequence

import numpy as np

from .emu import EmuConfig, run_spmv
from .layout import make_layout
from .migration import count_migrations, migration_arrivals, \
    remote_access_matrix, shard_load_map
from .partition import Partition, make_partition
from .reorder import REORDERINGS, reordering_permutation
from .sparse_matrix import CSRMatrix, ELL_LANE, ELL_SUBLANE, csr_from_coo, \
    csr_row_nnz, hyb_cap_width
from .spmv import PLAN_EXCHANGES, PLAN_KERNELS, SpmvPlan
from ..kernels.ops import SEG_CHUNK

__all__ = ["DEFAULT_PROBE", "KERNELS", "SPLIT_CORES", "SPLIT_MIN_SPAN",
           "MatrixFeatures", "ShardFeatures",
           "PlanCost", "RankedPlan", "PlanChoice", "extract_features",
           "extract_shard_features", "estimate_cost", "autotune",
           "feature_key", "PlanCache", "kernel_shard_costs", "select_shard_kernels",
           "exchange_shard_costs", "select_shard_exchanges",
           "remote_row_share", "device_path_model", "split_meta"]

#: Bases the autotuner re-ranks with the Emu timeline simulator when the
#: caller does not pass ``probe``.  Probing is on by default since the
#: vectorized tick engine made a probe cost milliseconds instead of
#: minutes; pass ``probe=0`` for the analytic-only ranking.
DEFAULT_PROBE = 4

#: Adaptive-probe (``probe="auto"``) stopping rule: keep probing distinct
#: bases in analytic-rank order, tracking the pairwise *inversion rate*
#: between the analytic ordering and the measured seconds among probed
#: bases.  Once at least ``AUTO_PROBE_MIN`` bases are probed and the rate
#: has moved by at most ``AUTO_PROBE_TOL`` for ``AUTO_PROBE_STREAK``
#: consecutive probes, the analytic ranking is trusted for the remaining
#: tail — the estimate of how often the model mis-orders bases has
#: stopped changing, so more probes no longer buy information.
AUTO_PROBE_MIN = 4
AUTO_PROBE_STREAK = 2
AUTO_PROBE_TOL = 0.05


def _inversion_rate(seconds: Sequence[float]) -> float:
    """Pairwise inversion rate of measured seconds vs analytic order.

    ``seconds`` is listed in analytic-rank order (best model total
    first); an inversion is a pair the probe measured in the opposite
    order.  0.0 = the model's ordering is fully trustworthy so far.
    """
    n = len(seconds)
    if n < 2:
        return 0.0
    inv = sum(1 for i in range(n) for j in range(i + 1, n)
              if seconds[i] > seconds[j])
    return inv / (n * (n - 1) / 2)

#: Weight of the TPU-side kernel-execution term relative to Emu issue
#: cycles.  Small enough that Emu-visible terms dominate across (layout,
#: distribution, reordering) bases; decisive between the per-shard
#: ``ell``/``seg``/``hyb`` kernels, which the Emu terms cannot distinguish.
_W_PAD = 0.02
#: Cycles charged per x element moved by the collective exchange (halo
#: all-to-all vs all-gather) — again sub-dominant, decisive within a base.
_W_COMM = 0.25
#: Relative per-element cost of the two exchange mechanisms.  A halo
#: element is gathered through the send tables (indexed read on the
#: sender, positioned write on the reader) — ``_W_EXCH_GATHER`` each; an
#: all-gather element streams contiguously with no index math —
#: ``_W_EXCH_STREAM`` each.  A shard whose halo would cover more than
#: ``_W_EXCH_STREAM/_W_EXCH_GATHER`` of the padded vector is cheaper on
#: full replication — exactly the skewed shards of §IV; banded shards
#: keep the exact-entries halo.  ``select_shard_exchanges`` is the
#: per-shard argmin of these two columns.
_W_EXCH_GATHER = 2.0
_W_EXCH_STREAM = 1.0

#: Kernel formats a shard stage may select, in tie-break preference order
#: — alias of the single definition in ``spmv.PLAN_KERNELS`` (also aliased
#: as ``program.PROGRAM_KERNELS`` for the switch branch ids).
KERNELS = PLAN_KERNELS
#: Relative slot-cost weights behind :func:`kernel_shard_costs`.  An ELL
#: slab cell costs 1 (one regular FMA lane-slot, padding included); a seg
#: chunk cell costs ``_W_SEG_SCAN`` (the prefix-scan reads and writes each
#: slot) plus ``_W_SEG_PIECE`` per piece (the serialized carry fix-up
#: scatter-add); a HYB overflow entry costs ``_W_OVF`` (pure scatter-add,
#: no scan).  The absolute scale cancels inside a base — only the ratios
#: decide which format a shard gets.
_W_SEG_SCAN = 2.0
_W_SEG_PIECE = 16.0
_W_OVF = 8.0
#: Per-slot cost of the serialized cross-chunk carry chain: a row spanning
#: ``span`` chunks accumulates ``span`` piece carries into one output row
#: sequentially, so the seg fix-up's critical path grows with the longest
#: row — the §IV-D monster-row hot-spot surviving inside the seg format.
_W_SEG_CARRY = 4.0
#: Per-partial-slot cost of the split stage-2 combine ((NS, R) reads).
_W_SPLIT_COMBINE = 1.0
#: Per-cell cost of a dense (8, 128) tile in the bitmask-tiled walk.
#: Cheaper than an ELL slot: the tile stream has **no per-element column
#: index** (one block-column id per 1024 cells) and x moves in
#: lane-aligned tiles instead of gathered scalars — the cell is one FMA
#: against streamed operands, about half an ELL slot's data+index+gather.
_W_TILE = 0.5
#: Per-occupied-tile overhead of the coarse pointer walk (tid/bc table
#: entry, block-row scatter).
_W_TILE_PTR = 2.0

#: Core count the split policy tries to keep busy — one Emu nodelet's
#: hardware thread contexts (the ``get_cu_num`` analogue in aiter's
#: ``get_meta_param``).
SPLIT_CORES = EmuConfig().threads_per_nodelet
#: Minimum longest-row chunk span before splitting pays: below this the
#: carry chain is already short and stage 2 is pure overhead.
SPLIT_MIN_SPAN = 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=4096)
def split_meta(nnz: int, max_row_nnz: int, num_cores: int = SPLIT_CORES,
               chunk: int = SEG_CHUNK) -> int:
    """Split count NS for one shard (the ``get_meta_param`` analogue).

    Driven by the shard's nnz stream and its longest row, exactly like
    aiter's occupancy heuristic is driven by batch/head geometry and the
    CU count: ``span = ceil(max_row_nnz / chunk)`` is the length of the
    serialized carry chain the seg fix-up would pay.  Shards whose rows
    all fit a few chunks (``span < SPLIT_MIN_SPAN``) keep NS=1 — stage 2
    would be pure overhead.  Otherwise NS is chosen so that (a) every
    core sees work even when the shard is one monster row (``NS >=
    span``), (b) a shard holding *several* monster rows still cuts each
    chain (``NS >= 2 * chunks / span`` keeps chunks-per-split at or
    under span/2), capped by the chunk count and the core budget, and
    floored to a power of two for even stage-2 tree reduction.  Cached:
    the planner calls this per shard per candidate base.

    >>> split_meta(100, 10)                    # short rows: no split
    1
    >>> split_meta(8192, 8192)                 # one monster row
    16
    >>> split_meta(3 * 8192, 8192) >= 16       # three monster rows
    True
    """
    chunks = max((nnz + chunk - 1) // chunk, 1)
    span = max((max_row_nnz + chunk - 1) // chunk, 1)
    if span < SPLIT_MIN_SPAN or chunks < 2:
        return 1
    want = max(span, -(-2 * chunks // span))
    ns = max(min(chunks, max(num_cores, 1), want), 1)
    p = 1
    while p * 2 <= ns:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    """Structural features that drive plan selection.

    All fields are plain Python scalars so the dataclass JSON round-trips
    exactly.  Extraction is deterministic: every statistic is an exact
    vectorized reduction over the matrix (no sampling, no RNG).

    Attributes
    ----------
    nrows, ncols, nnz : int
        Matrix dimensions and stored non-zeros.
    density : float
        ``nnz / (nrows * ncols)``.
    row_nnz_mean, row_nnz_cv, row_nnz_max : float
        Mean / coefficient of variation / max of per-row non-zero counts.
        High CV is the paper's §IV-C trigger for the nonzero distribution.
    tail_share : float
        Fraction of all non-zeros held by the heaviest 1% of rows — the
        power-law-tail indicator (webbase/rmat style matrices).
    bandwidth_mean, bandwidth_p95 : float
        Mean and 95th-percentile of ``|i - j| / ncols`` over stored
        entries.  Small values mean a banded matrix whose block layout is
        already migration-cheap (ford1/audikw_1).
    hot_col_share : float
        Largest per-shard share of all x loads under a row partition +
        block layout, computed from
        :func:`~repro_torch.core.migration.remote_access_matrix` — the §IV-D
        hot-spot indicator (cop20k_A's nodelet 0 serves ~25%).
    remote_frac : float
        Off-diagonal mass of the same access matrix: the fraction of x
        loads that are remote at all.
    """

    nrows: int
    ncols: int
    nnz: int
    density: float
    row_nnz_mean: float
    row_nnz_cv: float
    row_nnz_max: float
    tail_share: float
    bandwidth_mean: float
    bandwidth_p95: float
    hot_col_share: float
    remote_frac: float

    def to_dict(self) -> dict:
        """Return the features as a plain ``dict`` (JSON-ready)."""
        return dataclasses.asdict(self)


def extract_features(csr: CSRMatrix, *, num_shards: int = 8) -> MatrixFeatures:
    """Extract plan-selection features from a CSR matrix.

    Parameters
    ----------
    csr : CSRMatrix
        Host matrix (any shape; hot-column share uses a row partition over
        ``num_shards`` shards).
    num_shards : int, optional
        Shard count the hot-column / remote-fraction statistics are
        measured against (default 8, the Emu Chick nodelet count).

    Returns
    -------
    MatrixFeatures
        Deterministic scalar features (see the class docstring).

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.core.sparse_matrix import csr_from_coo
    >>> from repro_torch.core.plan import extract_features
    >>> eye = csr_from_coo(np.arange(8), np.arange(8), np.ones(8), (8, 8))
    >>> f = extract_features(eye, num_shards=4)
    >>> (f.nnz, round(f.row_nnz_cv, 3), round(f.bandwidth_mean, 3))
    (8, 0.0, 0.0)
    >>> f.remote_frac        # diagonal: every x load is shard-local
    0.0
    """
    per_row = csr_row_nnz(csr).astype(np.float64)
    mean = float(per_row.mean()) if csr.nrows else 0.0
    cv = float(per_row.std() / mean) if mean else 0.0
    top = max(int(np.ceil(csr.nrows * 0.01)), 1)
    tail = float(np.sort(per_row)[-top:].sum() / max(csr.nnz, 1))

    rows_of_nnz = np.repeat(np.arange(csr.nrows), csr_row_nnz(csr))
    if csr.nnz:
        dist = np.abs(rows_of_nnz - csr.col_index.astype(np.int64))
        bw_mean = float(dist.mean() / max(csr.ncols, 1))
        bw_p95 = float(np.percentile(dist, 95) / max(csr.ncols, 1))
    else:
        bw_mean = bw_p95 = 0.0

    part = make_partition(csr, num_shards, "row")
    T = remote_access_matrix(csr, part, make_layout("block", csr.ncols,
                                                    num_shards))
    tot = float(T.sum())
    hot = float(T.sum(axis=0).max() / tot) if tot else 0.0
    remote = float((tot - np.trace(T)) / tot) if tot else 0.0

    return MatrixFeatures(
        nrows=csr.nrows, ncols=csr.ncols, nnz=csr.nnz,
        density=float(csr.nnz / max(csr.nrows * csr.ncols, 1)),
        row_nnz_mean=mean, row_nnz_cv=cv, row_nnz_max=float(per_row.max())
        if csr.nrows else 0.0,
        tail_share=tail, bandwidth_mean=bw_mean, bandwidth_p95=bw_p95,
        hot_col_share=hot, remote_frac=remote)


@dataclasses.dataclass(frozen=True)
class ShardFeatures:
    """Structural features of one shard's row slice (plain scalars).

    The per-shard analogue of :class:`MatrixFeatures`: what the per-shard
    kernel selector reacts to.  A shard with low ``row_nnz_cv`` and a
    moderate ``row_nnz_max`` keeps the regular ELL slab; a skewed shard
    (``row_nnz_cv`` high, ``tail_share`` high) pushes toward ``seg`` or
    ``hyb``; a block-structured shard (``tile_fill`` high — its nonzeros
    concentrate into few dense (8, 128) tiles) pushes toward ``tile``.
    Serialized with the :class:`PlanChoice` so an operator can audit
    *why* each shard got its kernel.  ``tile_fill`` defaults to 0.0 so
    pre-tile JSON still loads.
    """

    shard: int
    rows: int
    nnz: int
    row_nnz_mean: float
    row_nnz_cv: float
    row_nnz_max: float
    tail_share: float
    tile_fill: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def extract_shard_features(csr: CSRMatrix,
                           part: Partition) -> tuple:
    """Per-shard structural features for every row slice of ``part``.

    Examples
    --------
    >>> from repro_torch.core.partition import make_partition
    >>> from repro_torch.core.plan import extract_shard_features
    >>> from repro_torch.data.matrices import powerlaw
    >>> A = powerlaw(512, 8000, seed=0)
    >>> fs = extract_shard_features(A, make_partition(A, 4, "nonzero"))
    >>> len(fs), fs[0].shard, sum(f.nnz for f in fs) == A.nnz
    (4, 0, True)
    """
    per_row = csr_row_nnz(csr).astype(np.float64)
    rows_of_nnz = np.repeat(np.arange(csr.nrows), csr_row_nnz(csr))
    out = []
    for p in range(part.num_shards):
        r0, r1 = int(part.starts[p]), int(part.starts[p + 1])
        rows = per_row[r0:r1]
        nnz_p = int(csr.row_ptr[r1] - csr.row_ptr[r0])
        mean = float(rows.mean()) if r1 > r0 else 0.0
        cv = float(rows.std() / mean) if mean else 0.0
        top = max(int(np.ceil((r1 - r0) * 0.01)), 1)
        tail = float(np.sort(rows)[-top:].sum() / max(nnz_p, 1)) \
            if r1 > r0 else 0.0
        tiles = _shard_tile_count(csr, rows_of_nnz, r0, r1)
        fill = nnz_p / (tiles * ELL_SUBLANE * ELL_LANE) if tiles else 0.0
        out.append(ShardFeatures(
            shard=p, rows=r1 - r0, nnz=nnz_p, row_nnz_mean=mean,
            row_nnz_cv=cv,
            row_nnz_max=float(rows.max()) if r1 > r0 else 0.0,
            tail_share=tail, tile_fill=float(fill)))
    return tuple(out)


def _shard_tile_count(A: CSRMatrix, rows_of_nnz: np.ndarray, r0: int,
                      r1: int) -> int:
    """Occupied (8, 128) tiles of a shard's row slice — the block grid of
    :func:`~repro_torch.core.sparse_matrix.csr_to_tile` on the shard CSR, so
    the cost model charges exactly what the lowered tile stage stores."""
    n0, n1 = int(A.row_ptr[r0]), int(A.row_ptr[r1])
    if n1 == n0:
        return 0
    brow = (rows_of_nnz[n0:n1] - r0) // ELL_SUBLANE
    bcol = A.col_index[n0:n1] // ELL_LANE
    Nb = max(-(-A.ncols // ELL_LANE), 1)
    return int(np.unique(brow.astype(np.int64) * Nb + bcol).size)


def feature_key(features: MatrixFeatures) -> tuple:
    """Coarse structural signature for feature-keyed plan caching.

    Sizes are binned to half-octaves (2x in nnz never collides, ~1.4x
    may) and the shape statistics are rounded to the resolution at which
    the cost model actually changes its mind; two matrices with equal
    keys are structurally similar enough that the autotuned plan for one
    is a sound choice for the other.  ``SparseMatrixEngine`` uses this to
    skip the full autotune grid when re-ingesting look-alike matrices;
    the leading version tag lets the binning evolve without silently
    reusing stale persisted keys.

    Examples
    --------
    >>> from repro_torch.core.plan import extract_features, feature_key
    >>> from repro_torch.data.matrices import make_matrix
    >>> a = extract_features(make_matrix("rmat", scale=0.002, seed=0))
    >>> b = extract_features(make_matrix("rmat", scale=0.002, seed=7))
    >>> feature_key(a) == feature_key(b)        # same structure, new seed
    True
    >>> c = extract_features(make_matrix("ford1", scale=0.05))
    >>> feature_key(a) == feature_key(c)        # different archetype
    False
    """
    def half_octave(v: int) -> int:
        return int(round(2.0 * np.log2(max(v, 1))))

    return ("fk1", half_octave(features.nrows), half_octave(features.ncols),
            half_octave(features.nnz),
            round(features.row_nnz_cv, 1), round(features.tail_share, 2),
            round(features.bandwidth_mean, 1),
            round(features.bandwidth_p95, 1),
            round(features.hot_col_share, 1),
            round(features.remote_frac, 1))


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Analytic cost breakdown for one plan, in Gossamer-Core cycles.

    ``issue_cycles`` is the critical-path memory-instruction term (max over
    nodelets, :class:`~repro_torch.core.emu.EmuConfig` ``access_cycles`` each);
    ``ingress_cycles`` the migration-arrival service time at the hottest
    nodelet (the §IV-D collapse mechanism); ``migration_cycles`` the
    per-thread migration overhead; ``padding_cycles`` the (down-weighted)
    TPU-side kernel-execution-slot term — :func:`kernel_shard_costs`
    summed over shards, the term that separates the per-shard
    ``ell``/``seg``/``hyb`` kernels (the field name predates the per-shard
    refactor and is kept for JSON back-compatibility);
    ``comm_cycles`` the (down-weighted) collective-volume term that
    separates ``halo``/``allgather`` — since the per-shard exchange axis
    it is the hottest reader's weighted ingest under the plan's
    (possibly per-shard) policies.  ``overlap_cycles`` is the part of
    the schedule the pipelined executor hides: the smaller of the comm
    term and the local-slice share of the kernel term (rows with no
    remote reads execute while the collective is in flight), and
    ``total = max(issue, ingress) + migration + padding + comm -
    overlap`` is the ranking key.  ``overlap_cycles`` defaults to 0.0 so
    JSON written before the pipelined executor still loads.
    """

    issue_cycles: float
    ingress_cycles: float
    migration_cycles: float
    padding_cycles: float
    comm_cycles: float
    total: float
    overlap_cycles: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RankedPlan:
    """One scored candidate: the plan, its model cost, optional probe time."""

    plan: SpmvPlan
    cost: PlanCost
    probe_seconds: float | None = None
    probe_mbs: float | None = None

    def to_dict(self) -> dict:
        return {"plan": dataclasses.asdict(self.plan),
                "cost": self.cost.to_dict(),
                "probe_seconds": self.probe_seconds,
                "probe_mbs": self.probe_mbs}


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """Ranked autotuning result (best candidate first).

    ``ranking[0].plan`` is the chosen plan; :meth:`to_json` /
    :meth:`from_json` round-trip the whole object, so a serving layer can
    persist the decision next to the ingested matrix.

    JSON written before the per-shard refactor (no ``shard_kernels`` plan
    field, no ``shard_features`` entry) still loads: the missing fields
    default to ``None``, which lowers as the uniform program
    (``tests/test_plan.py`` pins a legacy fixture).
    """

    features: MatrixFeatures
    ranking: tuple[RankedPlan, ...]
    probed: int
    #: Per-shard features of the winning plan's (reordered) partition —
    #: the audit trail for its shard_kernels.  None on legacy JSON and on
    #: externally-supplied plans.
    shard_features: tuple | None = None
    #: Bottleneck class of the whole matrix / of each winning-partition
    #: shard (:meth:`repro_torch.core.oracle.CostOracle.classify` — the Elafrou
    #: bandwidth/latency/imbalance taxonomy).  Deterministic functions of
    #: the features above, persisted so a serving layer can audit *why*
    #: a plan was picked.  None on legacy JSON.
    bottleneck: str | None = None
    shard_bottlenecks: tuple | None = None

    @property
    def plan(self) -> SpmvPlan:
        """The winning :class:`~repro_torch.core.spmv.SpmvPlan`."""
        return self.ranking[0].plan

    def to_json(self, indent: int | None = None) -> str:
        """Serialize to a JSON string (stable field order)."""
        return json.dumps({
            "features": self.features.to_dict(),
            "ranking": [r.to_dict() for r in self.ranking],
            "probed": self.probed,
            "shard_features": None if self.shard_features is None else
            [f.to_dict() for f in self.shard_features],
            "bottleneck": self.bottleneck,
            "shard_bottlenecks": None if self.shard_bottlenecks is None
            else list(self.shard_bottlenecks),
        }, indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "PlanChoice":
        """Inverse of :meth:`to_json` (exact dataclass equality).

        Tolerates pre-per-shard JSON: absent ``shard_features`` /
        ``plan.shard_kernels`` load as ``None`` (uniform program); absent
        ``bottleneck`` / ``shard_bottlenecks`` (pre-oracle JSON) load as
        ``None`` too."""
        d = json.loads(s)
        ranking = tuple(
            RankedPlan(plan=SpmvPlan(**r["plan"]),
                       cost=PlanCost(**r["cost"]),
                       probe_seconds=r["probe_seconds"],
                       probe_mbs=r["probe_mbs"])
            for r in d["ranking"])
        sf = d.get("shard_features")
        sb = d.get("shard_bottlenecks")
        return cls(features=MatrixFeatures(**d["features"]),
                   ranking=ranking, probed=int(d["probed"]),
                   shard_features=None if sf is None else
                   tuple(ShardFeatures(**f) for f in sf),
                   bottleneck=d.get("bottleneck"),
                   shard_bottlenecks=None if sb is None else tuple(sb))


# --------------------------------------------------------------------------
# cost model
# --------------------------------------------------------------------------

def _base_metrics(A: CSRMatrix, part: Partition, layout: str,
                  emu: EmuConfig,
                  col_weight: np.ndarray | None = None) -> dict:
    """Emu-visible cost terms shared by every (kernel, exchange) variant.

    ``col_weight`` (per-column activity, in ``A``'s index order) switches
    the issue and ingress terms to their traffic-weighted versions, so the
    ranking optimizes for the workload actually observed instead of the
    dense all-columns-hot one; the migration-overhead and exchange-volume
    terms stay structural (they are properties of the built program, not
    of one request).
    """
    S = part.num_shards
    xl = make_layout(layout, A.ncols, S)
    bl = make_layout(layout, A.nrows, S)
    tr = count_migrations(A, part, xl, bl)
    arrivals = migration_arrivals(A, part, xl, col_weight=col_weight)
    if col_weight is None:
        issue = float(tr.mem_instr_per_nodelet.max()) * emu.access_cycles
    else:
        lm, base = shard_load_map(A, part, xl, bl)
        issue = float((lm @ col_weight + base).max()) * emu.access_cycles
    ingress = float(arrivals.max()) * emu.tick_cycles / emu.ingress_rate
    migration = tr.migrations / S * emu.migration_overhead_cycles

    # Exchange volumes (x elements per shard): all-gather replicates the
    # padded vector; halo moves S * H where H is the max unique remote-x
    # set any (reader, owner) pair exchanges (build_halo pads to the max).
    rows_of_nnz = np.repeat(np.arange(A.nrows), csr_row_nnz(A))
    home_of_nnz = part.owner_of_rows(A.nrows)[rows_of_nnz]
    owners = xl.owner_of(A.col_index)
    remote = owners != home_of_nnz
    if remote.any():
        key = home_of_nnz[remote].astype(np.int64) * A.ncols + \
            A.col_index[remote].astype(np.int64)
        uniq = np.unique(key)
        up, ucol = uniq // A.ncols, uniq % A.ncols
        pair_counts = np.zeros((S, S), dtype=np.int64)
        np.add.at(pair_counts, (up, xl.owner_of(ucol)), 1)
        H = int(pair_counts.max())
        halo_per_shard = pair_counts.sum(axis=1).astype(np.float64)
    else:
        H = 0
        halo_per_shard = np.zeros(S, dtype=np.float64)
    return {"issue": issue, "ingress": ingress, "migration": migration,
            "halo_elems": S * max(H, 1), "allgather_elems": xl.padded_length(),
            "halo_per_shard": halo_per_shard, "part": part}


def kernel_shard_costs(A: CSRMatrix, part: Partition) -> dict:
    """Per-shard analytic execution-slot cost of every kernel format.

    Returns ``{kernel: (S,) float64}``.  The model charges what each
    format actually executes on a shard's row slice:

    * ``ell``   — every padded slab cell: ``round_up(rows, 8) *
      round_up(max_row_nnz, 128)``.  Regular stream, but a single heavy
      row inflates every row's width.
    * ``seg``   — ``_W_SEG_SCAN`` per chunk cell (the prefix scan touches
      each slot twice) plus ``_W_SEG_PIECE`` per piece (the serialized
      carry fix-up scatter) plus ``_W_SEG_CARRY`` per slot of every
      row-spanning carry: a row covering ``span_r`` chunks serializes
      ``span_r - 1`` carries into one output row, and the charges *sum
      over rows* — a shard holding eight monster rows pays eight chains,
      not the single longest one (charging only ``max_r span_r`` was the
      monster-row under-count this model used to make).  Immune to
      row-width padding, but pays per-row bookkeeping — dense regular
      rows are cheaper in ELL.
    * ``hyb``   — the p95-capped slab (:func:`~repro_torch.core.sparse_matrix.
      hyb_cap_width`) plus ``_W_OVF`` per spilled entry.  Wins when a thin
      tail of hub rows would otherwise blow up the ELL width.
    * ``split`` — the seg scan/piece terms with every carry chain cut by
      the policy split count NS (:func:`split_meta`): each row's chain
      shrinks to ``ceil(span_r / NS)`` because each split scatters into
      its own partial accumulator, at the price of ``_W_SPLIT_COMBINE``
      per stage-2 partial slot (NS x padded rows).  Strictly worse than seg
      on short-row shards (NS=1 still pays the combine), strictly better
      once one row spans many chunks — exactly the §IV-D trade.
    * ``tile``  — ``_W_TILE`` per cell of every *occupied* (8, 128) tile
      plus ``_W_TILE_PTR`` per tile for the pointer walk.  The cell is
      cheaper than an ELL slot (no per-element column-index stream, x
      moves in lane-aligned tiles), but a scattered nonzero drags a
      whole 1024-cell tile in — tile wins on banded / block-structured
      shards (high fill, padding-free of ELL's max-width tax) and loses
      catastrophically on scattered ones, which is exactly the
      cache-blocking criterion of Elafrou et al. the selector needs.

    ``select_shard_kernels`` takes the per-shard argmin of this table and
    the plan cost model sums the selected column over shards
    (:func:`_plan_kernel_slots`): kernel slots are *aggregate* execution
    work — the single-host serving executor runs the stages sequentially,
    and on the device path wasted slots are wasted FLOPs/HBM traffic
    whichever shard issues them — so the per-shard argmin minimizes the
    term exactly, and a heterogeneous program strictly beats every uniform
    kernel whenever the selection is genuinely mixed.  (The parallel
    critical-path terms — issue, ingress — remain max-aggregated; the
    kernel term is the down-weighted tax on top.)
    """
    S = part.num_shards
    per_row = csr_row_nnz(A)
    rows_of_nnz = np.repeat(np.arange(A.nrows), per_row)
    out = {k: np.zeros(S, dtype=np.float64) for k in KERNELS}
    for p in range(S):
        r0, r1 = int(part.starts[p]), int(part.starts[p + 1])
        rows = per_row[r0:r1]
        nnz_p = int(A.row_ptr[r1] - A.row_ptr[r0])
        rows_pad = _round_up(max(r1 - r0, 1), ELL_SUBLANE)
        max_row = int(rows.max()) if r1 > r0 else 0
        W = _round_up(max(max_row, 1), ELL_LANE)
        out["ell"][p] = rows_pad * W
        chunks = max((nnz_p + SEG_CHUNK - 1) // SEG_CHUNK, 1)
        pieces = int((rows > 0).sum()) + chunks
        spans = -(-rows // SEG_CHUNK)          # chunks each row spans
        carries = int(np.maximum(spans - 1, 0).sum())
        scan = _W_SEG_SCAN * chunks * SEG_CHUNK + _W_SEG_PIECE * pieces
        out["seg"][p] = scan + _W_SEG_CARRY * carries * SEG_CHUNK
        Wc = hyb_cap_width(rows) if r1 > r0 else ELL_LANE
        ovf = int(np.maximum(rows - Wc, 0).sum())
        out["hyb"][p] = rows_pad * Wc + _W_OVF * ovf
        ns = split_meta(nnz_p, max_row)
        carries_s = int(np.maximum(-(-spans // ns) - 1, 0).sum())
        out["split"][p] = scan + \
            _W_SEG_CARRY * carries_s * SEG_CHUNK + \
            _W_SPLIT_COMBINE * ns * rows_pad
        tiles = max(_shard_tile_count(A, rows_of_nnz, r0, r1), 1)
        out["tile"][p] = tiles * (_W_TILE * ELL_SUBLANE * ELL_LANE
                                  + _W_TILE_PTR)
    return out


def select_shard_kernels(A: CSRMatrix, part: Partition,
                         kernels: Sequence[str] = KERNELS,
                         costs: dict | None = None) -> tuple:
    """Per-shard argmin of :func:`kernel_shard_costs` (ties prefer the
    earlier entry of ``kernels`` — the regular ELL stream by default).

    Examples
    --------
    A skewed power-law matrix never keeps the uncapped ELL slab on a
    hub-heavy shard:

    >>> from repro_torch.core.partition import make_partition
    >>> from repro_torch.core.plan import select_shard_kernels
    >>> from repro_torch.data.matrices import powerlaw
    >>> A = powerlaw(1024, 40000, seed=0)
    >>> sel = select_shard_kernels(A, make_partition(A, 4, "row"))
    >>> from repro_torch.core.plan import KERNELS
    >>> len(sel), set(sel) <= set(KERNELS)
    (4, True)
    """
    costs = kernel_shard_costs(A, part) if costs is None else costs
    kernels = tuple(kernels)
    return tuple(
        min(kernels, key=lambda k: (costs[k][p], kernels.index(k)))
        for p in range(part.num_shards))


def _plan_kernel_slots(costs: dict, plan: SpmvPlan) -> float:
    """Total kernel slot cost of a plan over all shards (per-shard aware)."""
    sk = plan.resolved_shard_kernels()
    return float(sum(costs[k][p] for p, k in enumerate(sk)))


def _majority_kernel(sel: tuple) -> str:
    counts = {k: 0 for k in KERNELS}
    for k in sel:
        counts[k] += 1
    return max(KERNELS, key=lambda k: (counts[k], -KERNELS.index(k)))


def exchange_shard_costs(A: CSRMatrix, part: Partition,
                         layout="block") -> dict:
    """Per-shard weighted exchange cost of both policies.

    Returns ``{policy: (S,) float64}`` — the elements reader shard p
    ingests under each policy, weighted by the mechanism's per-element
    cost: ``halo`` counts p's unique active remote columns (zero-valued
    stored entries excluded, matching the executor's tables) at
    ``_W_EXCH_GATHER`` each; ``allgather`` counts the full padded vector
    at ``_W_EXCH_STREAM`` each.  The per-shard argmin is
    :func:`select_shard_exchanges`; the plan cost's comm term takes the
    hottest reader (:func:`_assemble_cost`).  ``layout`` may be a layout
    name or a built :class:`~repro_torch.core.layout.VectorLayout`.
    """
    S = part.num_shards
    xl = layout if hasattr(layout, "owner_of") else \
        make_layout(layout, A.ncols, S)
    rows_of_nnz = np.repeat(np.arange(A.nrows), csr_row_nnz(A))
    home = part.owner_of_rows(A.nrows)[rows_of_nnz]
    owners = xl.owner_of(A.col_index)
    rem = (A.values != 0) & (owners != home)
    halo_per = np.zeros(S, dtype=np.float64)
    if rem.any():
        key = home[rem].astype(np.int64) * A.ncols + \
            A.col_index[rem].astype(np.int64)
        uniq = np.unique(key)
        np.add.at(halo_per, uniq // A.ncols, 1.0)
    return {"halo": _W_EXCH_GATHER * halo_per,
            "allgather": np.full(S, _W_EXCH_STREAM * float(xl.padded_length()),
                                 dtype=np.float64)}


def select_shard_exchanges(A: CSRMatrix, part: Partition, layout="block",
                           costs: dict | None = None) -> tuple:
    """Per-shard argmin of :func:`exchange_shard_costs` (ties prefer the
    earlier entry of :data:`~repro_torch.core.spmv.PLAN_EXCHANGES` — the
    exact-entries halo)."""
    costs = exchange_shard_costs(A, part, layout) if costs is None else costs
    return tuple(
        min(PLAN_EXCHANGES,
            key=lambda e: (costs[e][p], PLAN_EXCHANGES.index(e)))
        for p in range(part.num_shards))


def _majority_exchange(sel: tuple) -> str:
    counts = {e: 0 for e in PLAN_EXCHANGES}
    for e in sel:
        counts[e] += 1
    return max(PLAN_EXCHANGES,
               key=lambda e: (counts[e], -PLAN_EXCHANGES.index(e)))


def remote_row_share(A: CSRMatrix, part: Partition,
                     layout="block") -> np.ndarray:
    """(S,) fraction of each shard's stored entries living in rows that
    read at least one active remote x entry.

    This is the pipelined executor's slice split exactly
    (``program._row_remote_flags``): entries in all-local rows run in
    the local pass — issuable while the exchange is in flight — so
    ``1 - share`` of a shard's kernel slots can hide behind the
    collective.  ``layout`` may be a name or a built layout.
    """
    S = part.num_shards
    xl = layout if hasattr(layout, "owner_of") else \
        make_layout(layout, A.ncols, S)
    per_row = csr_row_nnz(A)
    rows_of_nnz = np.repeat(np.arange(A.nrows), per_row)
    home = part.owner_of_rows(A.nrows)[rows_of_nnz]
    owners = xl.owner_of(A.col_index)
    rem = (A.values != 0) & (owners != home)
    row_remote = np.zeros(A.nrows, dtype=bool)
    row_remote[rows_of_nnz[rem]] = True
    share = np.zeros(S, dtype=np.float64)
    for p in range(S):
        r0, r1 = int(part.starts[p]), int(part.starts[p + 1])
        nnz_p = int(A.row_ptr[r1] - A.row_ptr[r0])
        if nnz_p:
            share[p] = float(per_row[r0:r1][row_remote[r0:r1]].sum()) / nnz_p
    return share


def device_path_model(A: CSRMatrix, part: Partition, plan: SpmvPlan,
                      emu: EmuConfig | None = None) -> dict:
    """Modeled device-path (SPMD) latency of one SpMV, serial vs pipelined.

    The :class:`PlanCost` totals model the Emu machine, where the kernel
    term is *total work* (summed over nodelets).  The shard_map device
    path is SPMD: one step's latency is the **slowest shard's** kernel
    time plus the collective.  This helper prices exactly that from the
    same per-shard tables:

    * ``serial`` — the pre-pipeline schedule: the exchange completes
      before any kernel work, so latency is
      ``max_p(slots_p) + comm``.
    * ``pipelined`` — the local slice (all-local rows,
      :func:`remote_row_share`) runs during the collective:
      ``max(max_p(local_p), comm) + max_p(remote_p)``.

    ``A``/``part`` must already be in the plan's reordered index space.
    Returns the two latencies (cycles) plus every term.  The per-shard
    tables come from the :class:`~repro_torch.core.oracle.CostOracle` facade —
    the same single set of weights every other consumer queries.
    """
    from .oracle import DEFAULT_ORACLE as oracle
    emu = emu or EmuConfig(nodelets=plan.num_shards)
    costs = oracle.kernel_costs(A, part)
    slots = np.array([costs[k][p] for p, k in
                      enumerate(plan.resolved_shard_kernels())],
                     dtype=np.float64)
    share = remote_row_share(A, part, plan.layout)
    ex = oracle.exchange_costs(A, part, layout=plan.layout)
    per = np.array([ex[e][p] for p, e in
                    enumerate(plan.resolved_shard_exchanges())],
                   dtype=np.float64)
    comm = _W_COMM * max(float(per.max()), 1.0)
    t_all = _W_PAD * float(slots.max()) * emu.access_cycles
    t_loc = _W_PAD * float((slots * (1.0 - share)).max()) * emu.access_cycles
    t_rem = _W_PAD * float((slots * share).max()) * emu.access_cycles
    serial = t_all + comm
    pipelined = max(t_loc, comm) + t_rem
    return {"serial_cycles": serial, "pipelined_cycles": pipelined,
            "kernel_cycles": t_all, "local_slice_cycles": t_loc,
            "remote_slice_cycles": t_rem, "comm_cycles": comm,
            "speedup": serial / max(pipelined, 1e-12)}


def _permute_weights(w: np.ndarray, perm: np.ndarray | None) -> np.ndarray:
    """Carry per-column weights through a symmetric reordering.

    ``perm[old] = new`` (the :func:`~repro_torch.core.reorder.reordering_permutation`
    convention), so the weight of old column j must land at new index
    ``perm[j]``.
    """
    if perm is None:
        return w
    out = np.empty_like(w)
    out[perm] = w
    return out


def _active_submatrix(A: CSRMatrix, col_weight: np.ndarray,
                      seed: int = 0) -> CSRMatrix:
    """Traffic-importance-thinned structure (same shape) for probing.

    Each stored entry survives with probability ``min(w[col]/mean(w), 1)``
    — columns at or above mean activity keep every entry, colder columns
    are thinned in proportion to how rarely the request stream touches
    them.  The result is the structure *one expected request* exercises:
    probing it with the Emu engine measures how a plan handles the
    observed traffic, not the dense all-columns-hot workload.  Uniform
    weights return ``A`` unchanged (the probe degrades to the structural
    one), and thinning is deterministic for a given ``seed``.

    Callers comparing plans must thin **once in a common index order** and
    permute the thinned matrix per plan — thinning after reordering would
    hand each plan a different entry set.
    """
    w = np.asarray(col_weight, dtype=np.float64)
    mean = w.mean() if w.size else 0.0
    if mean <= 0:
        return A
    p = np.minimum(w / mean, 1.0)
    if (p >= 1.0).all():
        return A
    rng = np.random.default_rng(seed)
    keep = rng.random(A.nnz) < p[A.col_index]
    if keep.all() or not keep.any():
        return A
    rows = np.repeat(np.arange(A.nrows), csr_row_nnz(A))
    return csr_from_coo(rows[keep], A.col_index[keep], A.values[keep],
                        A.shape, sum_duplicates=False)


def estimate_cost(csr: CSRMatrix, plan: SpmvPlan, *,
                  emu: EmuConfig | None = None,
                  col_weight: np.ndarray | None = None) -> PlanCost:
    """Analytic cost of executing SpMV under ``plan`` on the Emu model.

    The matrix is reordered per ``plan.reordering`` before accounting, so
    the returned cost is for the plan exactly as ``build_distributed``
    would realize it.

    Parameters
    ----------
    csr : CSRMatrix
        Square host matrix (reorderings are symmetric permutations).
    plan : SpmvPlan
        Candidate configuration to score.
    emu : EmuConfig, optional
        Machine constants; defaults to ``EmuConfig(nodelets=plan.num_shards)``.
    col_weight : np.ndarray, optional
        (ncols,) per-column activity in the *caller's* index order (it is
        permuted alongside the matrix for reordered plans); weights the
        issue/ingress terms by observed traffic.

    Returns
    -------
    PlanCost
        Cycle-denominated breakdown; ``total`` is the ranking key.

    Examples
    --------
    A banded matrix is cheaper under a block layout than a cyclic one
    (paper Fig. 3):

    >>> import numpy as np
    >>> from repro_torch.core.plan import estimate_cost
    >>> from repro_torch.core.spmv import SpmvPlan
    >>> from repro_torch.data.matrices import banded
    >>> A = banded(512, 4096, 8, seed=0)
    >>> blk = estimate_cost(A, SpmvPlan(layout="block"))
    >>> cyc = estimate_cost(A, SpmvPlan(layout="cyclic"))
    >>> blk.total < cyc.total
    True
    """
    emu = emu or EmuConfig(nodelets=plan.num_shards)
    perm = reordering_permutation(csr, plan.reordering, seed=plan.seed,
                                  parts=plan.num_shards)
    if plan.reordering == "none":
        A, w = csr, col_weight
    else:
        A = csr.permuted(perm, perm)
        w = None if col_weight is None else _permute_weights(
            np.asarray(col_weight, dtype=np.float64), perm)
    from .oracle import DEFAULT_ORACLE as oracle
    part = make_partition(A, plan.num_shards, plan.distribution)
    base = _base_metrics(A, part, plan.layout, emu, col_weight=w)
    costs = oracle.kernel_costs(A, part)
    sk = plan.resolved_shard_kernels()
    slots_p = np.array([costs[k][p] for p, k in enumerate(sk)],
                       dtype=np.float64)
    share = remote_row_share(A, part, plan.layout)
    local_slots = float((slots_p * (1.0 - share)).sum())
    return _assemble_cost(base, float(slots_p.sum()),
                          plan.resolved_shard_exchanges(), emu,
                          local_slots=local_slots)


def _assemble_cost(base: dict, pad_slots: float, policies, emu: EmuConfig,
                   local_slots: float = 0.0) -> PlanCost:
    """Assemble a :class:`PlanCost` under the pipelined schedule.

    ``policies`` is a per-shard exchange tuple (or one uniform policy
    string); the comm term is the hottest reader's weighted ingest —
    ``_W_EXCH_GATHER`` per exact halo element vs ``_W_EXCH_STREAM`` per
    streamed full-replication element.  ``local_slots`` is the kernel
    slot share living in all-local rows: the pipelined executor runs
    those while the collective is in flight, so the smaller of that
    slice and the comm term comes off the serial total.
    """
    pad = _W_PAD * pad_slots * emu.access_cycles
    halo_per = base["halo_per_shard"]
    ag = float(base["allgather_elems"])
    if isinstance(policies, str):
        policies = (policies,) * len(halo_per)
    per_cost = [_W_EXCH_GATHER * float(halo_per[p]) if e == "halo"
                else _W_EXCH_STREAM * ag
                for p, e in enumerate(policies)]
    comm = _W_COMM * max(max(per_cost), 1.0)
    pad_local = min(_W_PAD * local_slots * emu.access_cycles, pad)
    overlap = min(comm, pad_local)
    total = max(base["issue"], base["ingress"]) + base["migration"] + \
        pad + comm - overlap
    return PlanCost(issue_cycles=float(base["issue"]),
                    ingress_cycles=float(base["ingress"]),
                    migration_cycles=float(base["migration"]),
                    padding_cycles=float(pad), comm_cycles=float(comm),
                    total=float(total), overlap_cycles=float(overlap))


# --------------------------------------------------------------------------
# autotuner
# --------------------------------------------------------------------------

def autotune(csr: CSRMatrix, *, num_shards: int = 8, seed: int = 0,
             layouts: Sequence[str] = ("block", "cyclic"),
             distributions: Sequence[str] = ("row", "nonzero"),
             reorderings: Iterable[str] = REORDERINGS,
             kernels: Sequence[str] = KERNELS,
             exchanges: Sequence[str] = ("halo", "allgather"),
             probe: int | str | None = None,
             emu: EmuConfig | None = None,
             col_weight: np.ndarray | None = None,
             per_shard: bool = True) -> PlanChoice:
    """Rank the candidate plan grid for one matrix.

    Scores every plan in ``layouts x distributions x reorderings x kernels
    x exchanges`` with :func:`estimate_cost` (reordered matrices and
    per-base migration accounting are computed once and shared).  With
    ``per_shard`` (the default), every (reordering, distribution) base
    additionally contributes a **heterogeneous candidate** whose kernel is
    selected shard-by-shard (:func:`select_shard_kernels` — the per-shard
    argmin of :func:`kernel_shard_costs`); the kernel term sums over
    shards, so the heterogeneous candidate's kernel term is never worse
    than any uniform kernel's on the same base, and strictly better
    exactly on the mixed-structure matrices the global plan loses on
    (``benchmarks/hetero_bench.py``).  When both exchange policies are in
    play, each base likewise contributes mixed-exchange candidates
    (:func:`select_shard_exchanges`, ``plan.shard_exchanges``) whenever
    the per-shard argmin over :func:`exchange_shard_costs` disagrees
    across shards.  The model's top candidates are then
    optionally re-ranked with a short empirical probe: the Emu timeline
    simulator (:func:`~repro_torch.core.emu.run_spmv`) run on the ``probe`` best
    distinct (reordering, layout, distribution) bases.  Probed candidates
    rank by measured seconds (model total as the tiebreak) ahead of
    unprobed ones; the probe cannot see kernels, so within a probed base
    the analytic kernel term still decides.

    Parameters
    ----------
    csr : CSRMatrix
        Square host matrix.
    num_shards : int, optional
        Shards/nodelets the plan targets (default 8).
    seed : int, optional
        Seed threaded into the stochastic reorderings (default 0).
    layouts, distributions, reorderings, kernels, exchanges : sequence of str
        Candidate axes; defaults are the full paper grid (kernels now
        include the HYB capped-ELL + overflow format, the split-nnz
        two-stage ``split`` family, and the bitmask-tiled ``tile``
        family).
    probe : int or "auto", optional
        Number of distinct bases to simulate; defaults to
        :data:`DEFAULT_PROBE` (0 = analytic only).  The probe runs the
        vectorized Emu engine, so re-ranking is cheap enough to stay on
        for serving-time ingestion (``serve.engine.SparseMatrixEngine``);
        ``benchmarks/autotune_bench.py`` checks the resulting regret.
        ``probe="auto"`` spends probes adaptively: bases are measured in
        analytic-rank order until the measured-vs-analytic pairwise
        inversion rate stabilizes (:data:`AUTO_PROBE_MIN` /
        :data:`AUTO_PROBE_TOL` / :data:`AUTO_PROBE_STREAK`), so easy
        matrices stop after a handful of probes while model-hostile ones
        keep probing up to the full base grid — this is what lets
        ``benchmarks/hetero_bench.py`` drop its fixed ``probe=20``.
    emu : EmuConfig, optional
        Machine constants for both the model and the probe.
    col_weight : np.ndarray, optional
        (ncols,) per-column activity in the caller's index order.  When
        given, the analytic issue/ingress terms are traffic-weighted and
        the simulator probe runs on the traffic-active submatrix
        (:func:`_active_submatrix`) — the re-plan path of the serving
        rebalancer (``serve/rebalance.py``).  Uniform weights reproduce
        the unweighted ranking.
    per_shard : bool, optional
        Add the per-shard heterogeneous candidates (default True); pass
        False for the pre-refactor uniform-kernel grid (what
        ``benchmarks/hetero_bench.py`` calls the *best global* baseline).

    Returns
    -------
    PlanChoice
        Features + full ranking, best candidate first, plus the winning
        partition's per-shard features (:class:`ShardFeatures`).

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.core.plan import autotune
    >>> from repro_torch.data.matrices import powerlaw
    >>> A = powerlaw(256, 2048, seed=0)
    >>> choice = autotune(A, num_shards=4)
    >>> choice.probed                 # simulator re-ranking, on by default
    4
    >>> choice.plan.distribution      # skewed rows -> nonzero split wins
    'nonzero'
    >>> len(choice.ranking) >= 2 * 2 * 5 * 5 * 2   # + per-shard candidates
    True
    >>> len(choice.shard_features)    # winner's per-shard audit trail
    4
    """
    from .oracle import DEFAULT_ORACLE as oracle
    emu = emu or EmuConfig(nodelets=num_shards)
    probe = DEFAULT_PROBE if probe is None else probe
    adaptive = isinstance(probe, str)
    if adaptive and probe != "auto":
        raise ValueError(f"probe must be an int or 'auto', got {probe!r}")
    if col_weight is not None:
        col_weight = np.asarray(col_weight, dtype=np.float64)

    reordered: dict[str, CSRMatrix] = {}
    weights: dict[str, np.ndarray | None] = {}
    perms: dict[str, np.ndarray] = {}
    for method in reorderings:
        perm = reordering_permutation(csr, method, seed=seed,
                                      parts=num_shards)
        perms[method] = perm
        if method == "none":
            reordered[method], weights[method] = csr, col_weight
        else:
            reordered[method] = csr.permuted(perm, perm)
            weights[method] = None if col_weight is None else \
                _permute_weights(col_weight, perm)

    bases: dict[tuple, dict] = {}
    parts: dict[tuple, Partition] = {}
    candidates: list[RankedPlan] = []
    for method, A in reordered.items():
        for dist in distributions:
            part = make_partition(A, num_shards, dist)
            parts[(method, dist)] = part
            costs = oracle.kernel_costs(A, part)
            shard_sel = None
            if per_shard and len(kernels) > 1:
                sel = oracle.select_kernels(A, part, kernels=kernels,
                                            costs=costs)
                if len(set(sel)) > 1:     # uniform pick == existing plan
                    shard_sel = sel
            for layout in layouts:
                key = (method, layout, dist)
                bases[key] = _base_metrics(A, part, layout, emu,
                                           col_weight=weights[method])
                share = remote_row_share(A, part, layout)
                ex_sel = None
                if per_shard and "halo" in exchanges \
                        and "allgather" in exchanges:
                    sel = oracle.select_exchanges(A, part, layout)
                    if len(set(sel)) > 1:  # uniform pick == existing plan
                        ex_sel = sel
                loc = {k: float((costs[k] * (1.0 - share)).sum())
                       for k in kernels}
                for kernel in kernels:
                    for exchange in exchanges:
                        plan = SpmvPlan(layout=layout, distribution=dist,
                                        reordering=method, exchange=exchange,
                                        kernel=kernel, num_shards=num_shards,
                                        seed=seed)
                        cost = _assemble_cost(bases[key],
                                              float(costs[kernel].sum()),
                                              exchange, emu,
                                              local_slots=loc[kernel])
                        candidates.append(RankedPlan(plan=plan, cost=cost))
                    if ex_sel is not None:
                        plan = SpmvPlan(layout=layout, distribution=dist,
                                        reordering=method,
                                        exchange=_majority_exchange(ex_sel),
                                        kernel=kernel, num_shards=num_shards,
                                        seed=seed, shard_exchanges=ex_sel)
                        cost = _assemble_cost(bases[key],
                                              float(costs[kernel].sum()),
                                              ex_sel, emu,
                                              local_slots=loc[kernel])
                        candidates.append(RankedPlan(plan=plan, cost=cost))
                if shard_sel is not None:
                    slots = float(sum(costs[k][p]
                                      for p, k in enumerate(shard_sel)))
                    slots_loc = float(sum(costs[k][p] * (1.0 - share[p])
                                          for p, k in enumerate(shard_sel)))
                    hetero_ex = list(exchanges)
                    if ex_sel is not None:
                        hetero_ex.append(ex_sel)
                    for exchange in hetero_ex:
                        uniform = isinstance(exchange, str)
                        plan = SpmvPlan(
                            layout=layout, distribution=dist,
                            reordering=method,
                            exchange=exchange if uniform
                            else _majority_exchange(exchange),
                            kernel=_majority_kernel(shard_sel),
                            num_shards=num_shards, seed=seed,
                            shard_kernels=shard_sel,
                            shard_exchanges=None if uniform else exchange)
                        cost = _assemble_cost(bases[key], slots, exchange,
                                              emu, local_slots=slots_loc)
                        candidates.append(RankedPlan(plan=plan, cost=cost))

    candidates.sort(key=lambda r: r.cost.total)

    n_probed = 0
    if adaptive or probe > 0:
        # Traffic-thinned probe source, cut once in the caller's order so
        # every probed base sees the same entry set (then permuted per
        # reordering alongside the plan itself).
        probe_src = csr if col_weight is None else \
            _active_submatrix(csr, col_weight, seed=seed)
        probe_times: dict[tuple, tuple[float, float]] = {}
        auto_secs: list[float] = []   # analytic-rank order, adaptive mode
        auto_rate = 0.0
        auto_streak = 0
        auto_done = False
        for cand in candidates:
            key = (cand.plan.reordering, cand.plan.layout,
                   cand.plan.distribution)
            if key in probe_times:
                continue
            if auto_done if adaptive else len(probe_times) >= probe:
                continue
            A = reordered[cand.plan.reordering]
            part = make_partition(A, num_shards, cand.plan.distribution)
            if probe_src is csr:
                probe_A = A
            else:
                perm = perms[cand.plan.reordering]
                probe_A = probe_src if cand.plan.reordering == "none" \
                    else probe_src.permuted(perm, perm)
            res = run_spmv(probe_A, part,
                           make_layout(cand.plan.layout, A.ncols, num_shards),
                           emu)
            probe_times[key] = (float(res.seconds), float(res.bandwidth_mbs))
            if adaptive:
                auto_secs.append(float(res.seconds))
                rate = _inversion_rate(auto_secs)
                if len(auto_secs) >= AUTO_PROBE_MIN:
                    if abs(rate - auto_rate) <= AUTO_PROBE_TOL:
                        auto_streak += 1
                        if auto_streak >= AUTO_PROBE_STREAK:
                            auto_done = True
                    else:
                        auto_streak = 0
                auto_rate = rate
        probed = []
        for cand in candidates:
            key = (cand.plan.reordering, cand.plan.layout,
                   cand.plan.distribution)
            if key in probe_times:
                sec, mbs = probe_times[key]
                cand = dataclasses.replace(cand, probe_seconds=sec,
                                           probe_mbs=mbs)
            probed.append(cand)
        probed.sort(key=lambda r: (r.probe_seconds is None,
                                   r.probe_seconds or 0.0, r.cost.total))
        candidates = probed
        n_probed = len(probe_times)

    winner = candidates[0].plan
    shard_features = extract_shard_features(
        reordered[winner.reordering],
        parts[(winner.reordering, winner.distribution)])
    features = extract_features(csr, num_shards=num_shards)
    return PlanChoice(features=features,
                      ranking=tuple(candidates), probed=n_probed,
                      shard_features=shard_features,
                      bottleneck=oracle.classify(features),
                      shard_bottlenecks=oracle.classify_shards(
                          shard_features,
                          remote_frac=features.remote_frac))


# --------------------------------------------------------------------------
# plan cache (feature-keyed, disk-backed)
# --------------------------------------------------------------------------

class PlanCache:
    """Feature-keyed plan cache: in-memory L1 dict + optional disk L2.

    Keys are whatever the caller derives from :func:`feature_key` (the
    serving layer uses ``(feature_key(features), num_shards)``); values
    are :class:`~repro_torch.core.spmv.SpmvPlan`.  With ``cache_dir`` set, every
    ``put`` also writes a small JSON file named by the key's hash, so a
    *different engine instance* — or a restarted process — skips the
    autotune grid for any structurally similar matrix the fleet has seen.
    The stored key is verified verbatim on read (hash collisions and
    ``feature_key`` version bumps degrade to a miss, never a wrong plan),
    and corrupt or concurrently rewritten files read as misses too.

    >>> cache = PlanCache()
    >>> cache.put(("fk1", 8), SpmvPlan(kernel="seg"))
    >>> cache.get(("fk1", 8)).kernel
    'seg'
    >>> cache.get(("fk1", 9)) is None
    True
    """

    def __init__(self, cache_dir: str | None = None):
        self._mem: dict = {}
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key) -> str:
        h = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return os.path.join(self.cache_dir, f"plan_{h}.json")

    def get(self, key) -> SpmvPlan | None:
        """The cached plan for ``key``, promoting disk hits into the L1."""
        if key in self._mem:
            return self._mem[key]
        if not self.cache_dir:
            return None
        try:
            with open(self._path(key)) as f:
                d = json.load(f)
            if d.get("key") != repr(key):
                return None
            plan = SpmvPlan(**d["plan"])
        except (FileNotFoundError, json.JSONDecodeError, TypeError,
                ValueError, KeyError):
            return None
        self._mem[key] = plan
        return plan

    def put(self, key, plan: SpmvPlan) -> None:
        """Record ``key -> plan`` in the L1 and (atomically) on disk."""
        self._mem[key] = plan
        if not self.cache_dir:
            return
        d = dataclasses.asdict(plan)
        for f_ in ("shard_kernels", "split_counts", "shard_exchanges"):
            if d[f_] is not None:
                d[f_] = list(d[f_])
        path = self._path(key)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"key": repr(key), "plan": d}, f, indent=1)
        os.replace(tmp, path)

    def __len__(self) -> int:
        return len(self._mem)
