"""Bottleneck-aware cost oracle: one model behind every re-plan tier.

The paper's central finding is that the *winning* sparse optimization
depends on which resource the matrix actually stresses — reordering buys
~70% on Emu when migratory hot-spots are the bottleneck and almost
nothing when they are not (§IV-B/D).  Elafrou et al. (arXiv 1711.05487)
make this precise by classifying each matrix as **bandwidth-**,
**latency-** or **imbalance-bound** and attacking only the live
bottleneck; Asudeh et al. (arXiv 2506.10356) show a reordering only pays
when its one-time cost amortizes over enough SpMVs.

:class:`CostOracle` folds both into a single facade that every consumer
queries instead of reaching into the scatter of cost primitives in
:mod:`repro_torch.core.plan`:

* ``autotune`` (grid ranking + adaptive probe budget),
* ``device_path_model`` (SPMD serial-vs-pipelined latency),
* the rebalancer's partial tier (hot-shard kernel/exchange argmin) and
  full tier (budgeted re-autotune + swap gates), and
* the serving router's re-plan gate (amortization against per-tenant
  traffic volume).

The numeric cost tables themselves still live in ``plan.py`` (they are
the single set of weights); the oracle owns **classification** (which
bottleneck a matrix/shard is in), **class-aware scoring** (which
candidate attacks that bottleneck), **measured probing** (the Emu tick
machine, now format-aware via ``run_spmv(shard_kernels=...)``), and the
**amortization gate** (whether a re-plan pays at the observed request
volume).  Delegation keeps every legacy ranking bit-identical: consumers
that only need the tables get exactly the numbers they always got.

The port's host copy of ``repro.core.oracle`` (numpy only): the same
arithmetic, so its results equal the reference's bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .emu import EmuConfig, EmuResult, run_spmv
from .layout import make_layout
from .partition import Partition, make_partition
from .sparse_matrix import CSRMatrix

__all__ = ["CostOracle", "ReplanDecision", "DEFAULT_ORACLE",
           "BOTTLENECK_CLASSES", "REPLAN_SPMV_EQUIV"]

#: The three Elafrou bottleneck classes, in reporting order.
BOTTLENECK_CLASSES = ("bandwidth", "latency", "imbalance")

#: Classification thresholds (deterministic functions of
#: :class:`~repro_torch.core.plan.MatrixFeatures` — no sampling, no RNG, so the
#: class JSON-round-trips through ``PlanChoice`` exactly).
#:
#: *Imbalance-bound*: a heavy row-length tail means a few rows (or the
#: shards holding them) serialize the step — the paper's §IV-C/D trigger
#: for the nonzero distribution and the split family.
IMBALANCE_ROW_CV = 1.0
IMBALANCE_TAIL_SHARE = 0.25
#: A single hot column concentrates migration *arrivals* on its owner
#: nodelet (Fig. 8's nodelet-0 collapse) — ingress-limited, which the
#: model accounts as imbalance.
IMBALANCE_HOT_COL = 0.30
#: *Latency-bound*: most accesses migrate, so the machine is paying
#: migration round-trips rather than streaming local memory.
LATENCY_REMOTE_FRAC = 0.50

#: One-time cost of a swap, in *equivalent steady-state SpMVs* (the
#: Asudeh accounting).  A full re-plan re-runs the autotune grid, probes,
#: reorders and re-lowers every stage; a partial re-plan re-lowers only
#: hot shards through ``relower`` (shared stages are reused).  A re-plan
#: whose projected per-SpMV gain is ``g`` only pays if the tenant will
#: issue at least ``equiv / g`` more SpMVs against the new plan.
REPLAN_SPMV_EQUIV = {"full": 25.0, "partial": 4.0}


@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    """Outcome of the amortization gate for one candidate swap.

    ``pays`` is the decision; ``break_even_spmvs`` is how many SpMVs the
    swap needs to amortize at the projected gain (``inf`` when the gain
    is non-positive); ``horizon`` echoes the projected request volume the
    gate saw (``None`` = volume-blind legacy behavior, always pays).
    """

    pays: bool
    mode: str
    gain_frac: float
    horizon: float | None
    break_even_spmvs: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class CostOracle:
    """Facade over the plan-layer cost model + Emu probe + re-plan gates.

    Stateless apart from the machine constants: one process-wide
    :data:`DEFAULT_ORACLE` serves every consumer.  All ranking-relevant
    numeric methods delegate to the single set of weights in
    :mod:`repro_torch.core.plan`, so routing a consumer through the oracle
    never changes a legacy selection.
    """

    def __init__(self, emu: EmuConfig | None = None):
        self.emu = emu

    # -- delegated cost tables (the one set of weights) ------------------

    def kernel_costs(self, A: CSRMatrix, part: Partition) -> dict:
        """Per-shard analytic slot cost of every kernel format
        (:func:`~repro_torch.core.plan.kernel_shard_costs`)."""
        from . import plan
        return plan.kernel_shard_costs(A, part)

    def exchange_costs(self, A: CSRMatrix, part: Partition,
                       layout="block") -> dict:
        """Per-shard weighted exchange cost of both policies
        (:func:`~repro_torch.core.plan.exchange_shard_costs`)."""
        from . import plan
        return plan.exchange_shard_costs(A, part, layout)

    def select_kernels(self, A: CSRMatrix, part: Partition,
                       kernels: Sequence[str] | None = None,
                       costs: dict | None = None) -> tuple:
        """Per-shard kernel argmin
        (:func:`~repro_torch.core.plan.select_shard_kernels`)."""
        from . import plan
        return plan.select_shard_kernels(
            A, part, kernels=plan.KERNELS if kernels is None else kernels,
            costs=costs)

    def select_exchanges(self, A: CSRMatrix, part: Partition, layout="block",
                         costs: dict | None = None) -> tuple:
        """Per-shard exchange argmin
        (:func:`~repro_torch.core.plan.select_shard_exchanges`)."""
        from . import plan
        return plan.select_shard_exchanges(A, part, layout, costs=costs)

    def plan_cost(self, csr: CSRMatrix, plan_, *,
                  emu: EmuConfig | None = None,
                  col_weight: np.ndarray | None = None):
        """Analytic :class:`~repro_torch.core.plan.PlanCost` of one plan
        (:func:`~repro_torch.core.plan.estimate_cost`)."""
        from . import plan
        return plan.estimate_cost(csr, plan_, emu=emu or self.emu,
                                  col_weight=col_weight)

    def device_path(self, A: CSRMatrix, part: Partition, plan_,
                    emu: EmuConfig | None = None) -> dict:
        """SPMD serial-vs-pipelined latency terms
        (:func:`~repro_torch.core.plan.device_path_model`)."""
        from . import plan
        return plan.device_path_model(A, part, plan_, emu=emu or self.emu)

    # -- bottleneck classification (Elafrou) -----------------------------

    def classify(self, features) -> str:
        """Bottleneck class of a whole matrix from its
        :class:`~repro_torch.core.plan.MatrixFeatures`.

        Deterministic thresholds on exact structural reductions:

        * ``"imbalance"`` — heavy row tail (``row_nnz_cv`` /
          ``tail_share``) or a hot column concentrating migration
          arrivals (``hot_col_share``): a few rows or one ingress queue
          serialize the step.
        * ``"latency"``   — most accesses migrate
          (``remote_frac > 0.5``): the machine pays migration
          round-trips, so locality optimizations (reordering, block
          layout) are the live lever.
        * ``"bandwidth"`` — everything else: the step streams, and only
          format/padding efficiency moves the needle.
        """
        if (features.row_nnz_cv > IMBALANCE_ROW_CV
                or features.tail_share > IMBALANCE_TAIL_SHARE
                or features.hot_col_share > IMBALANCE_HOT_COL):
            return "imbalance"
        if features.remote_frac > LATENCY_REMOTE_FRAC:
            return "latency"
        return "bandwidth"

    def classify_shard(self, sf, remote_frac: float = 0.0) -> str:
        """Bottleneck class of one shard from its
        :class:`~repro_torch.core.plan.ShardFeatures`.

        Shard features carry the row-tail statistics; the migration
        share is a whole-matrix property, so callers pass the matrix's
        ``remote_frac`` for the latency test.
        """
        if (sf.row_nnz_cv > IMBALANCE_ROW_CV
                or sf.tail_share > IMBALANCE_TAIL_SHARE):
            return "imbalance"
        if remote_frac > LATENCY_REMOTE_FRAC:
            return "latency"
        return "bandwidth"

    def classify_shards(self, shard_features, remote_frac: float = 0.0
                        ) -> tuple:
        """Per-shard classes (one per ``ShardFeatures`` entry)."""
        return tuple(self.classify_shard(sf, remote_frac)
                     for sf in shard_features)

    def kernel_affinity(self, bottleneck: str) -> tuple:
        """Kernel-family *tie-break* ordering for one bottleneck class.

        The per-shard selection is always the cost-table argmin
        (:meth:`select_kernels`); this ordering only decides exact ties,
        so routing a consumer through it never flips a strict winner.
        A **bandwidth**-bound shard prefers the streaming formats —
        ``tile`` first (dense lane-aligned tile streams, no per-element
        index traffic), then the regular ELL slab; an **imbalance**-bound
        shard prefers the load-balanced nnz-stream formats (``split``
        cuts the monster-row carry chain, then ``seg`` / ``hyb``); a
        **latency**-bound shard keeps the default order — format choice
        is not the live lever when most accesses migrate.
        """
        from .plan import KERNELS
        if bottleneck == "bandwidth":
            pref = ("tile", "ell")
        elif bottleneck == "imbalance":
            pref = ("split", "seg", "hyb")
        elif bottleneck == "latency":
            pref = ()
        else:
            raise ValueError(f"unknown bottleneck class: {bottleneck!r}; "
                             f"expected one of {BOTTLENECK_CLASSES}")
        return tuple(pref) + tuple(k for k in KERNELS if k not in pref)

    def score(self, cost, bottleneck: str) -> float:
        """Class-aware ranking key: the plan total plus the term that
        attacks the live bottleneck, double-weighted.

        A bandwidth-bound matrix re-weights the streaming issue term; a
        latency-bound one the migration + exchange terms; an
        imbalance-bound one the hottest-queue ingress term.  Used by the
        *new* decision paths (adaptive probe ordering, re-plan gates) —
        legacy rankings keep the plain ``cost.total`` key so frozen
        fixture selections do not move.
        """
        if bottleneck == "bandwidth":
            return float(cost.total + cost.issue_cycles)
        if bottleneck == "latency":
            return float(cost.total + cost.migration_cycles
                         + cost.comm_cycles)
        if bottleneck == "imbalance":
            return float(cost.total + cost.ingress_cycles)
        raise ValueError(f"unknown bottleneck class: {bottleneck!r}; "
                         f"expected one of {BOTTLENECK_CLASSES}")

    # -- measured probing (Emu tick machine, format-aware) ---------------

    def probe(self, A: CSRMatrix, part: Partition, plan_, *,
              emu: EmuConfig | None = None,
              engine: str = "vectorized",
              kernel_aware: bool = True) -> EmuResult:
        """Run the Emu tick machine on one prepared (matrix, partition).

        ``A``/``part`` must already be in the plan's reordered index
        space (callers thin/permute first — see
        ``plan._active_submatrix``).  ``kernel_aware`` replays the
        *format-shaped* per-shard instruction streams of the plan
        (:func:`~repro_torch.core.emu.build_thread_traces`), so a kernel-only
        re-plan shows up in the measured probe instead of needing the
        analytic tables to break the tie.
        """
        emu = emu or self.emu or EmuConfig(nodelets=part.num_shards)
        xl = make_layout(plan_.layout, A.ncols, part.num_shards)
        sk = plan_.resolved_shard_kernels() if kernel_aware else None
        return run_spmv(A, part, xl, emu, engine=engine, shard_kernels=sk)

    def probe_seconds(self, csr: CSRMatrix, plan_, *,
                      col_weight: np.ndarray | None = None,
                      emu: EmuConfig | None = None,
                      kernel_aware: bool = True) -> float:
        """Measured Emu seconds of one plan on (optionally thinned) csr.

        Thins by traffic, reorders per the plan, partitions per the
        plan's distribution, and runs the format-aware probe — the
        rebalancer's swap-gate measurement in one call.
        """
        from . import plan as _p
        from .reorder import reordering_permutation
        A = csr if col_weight is None else \
            _p._active_submatrix(csr, col_weight, seed=plan_.seed)
        if plan_.reordering != "none":
            perm = reordering_permutation(csr, plan_.reordering,
                                          seed=plan_.seed,
                                          parts=plan_.num_shards)
            A = A.permuted(perm, perm)
        part = make_partition(A, plan_.num_shards, plan_.distribution)
        res = self.probe(A, part, plan_, emu=emu, kernel_aware=kernel_aware)
        return float(res.seconds)

    # -- split-swap structural guard -------------------------------------

    def split_span_ok(self, A: CSRMatrix, part: Partition,
                      shard: int) -> bool:
        """Whether shard ``shard`` of ``A`` has a row spanning at least
        ``SPLIT_MIN_SPAN`` seg chunks — the floor below which the split
        family's stage-2 combine is pure overhead.

        The rebalancer's partial tier evaluates swaps on a
        traffic-*thinned* structure: heavy thinning can shorten a truly
        monstrous row below the span floor, in which case a split swap
        chosen on the thinned table would deploy a useless stage 2 on
        the real matrix's short-row regime.  This guard makes the old
        docstring caveat executable.
        """
        from ..kernels.ops import SEG_CHUNK
        from .plan import SPLIT_MIN_SPAN
        from .sparse_matrix import csr_row_nnz
        r0, r1 = int(part.starts[shard]), int(part.starts[shard + 1])
        if r1 <= r0:
            return False
        max_row = int(csr_row_nnz(A)[r0:r1].max())
        span = (max_row + SEG_CHUNK - 1) // SEG_CHUNK
        return span >= SPLIT_MIN_SPAN

    # -- amortization gate (Asudeh) --------------------------------------

    def replan_pays(self, gain_frac: float, horizon: float | None,
                    mode: str = "full") -> ReplanDecision:
        """Whether a re-plan's one-time cost amortizes over the
        projected request volume.

        ``gain_frac`` is the projected fractional per-SpMV improvement
        (e.g. ``1 - new_total/old_total``); ``horizon`` the projected
        number of SpMVs the tenant will issue against the new plan (the
        router feeds its per-tenant traffic rate times the amortization
        window).  ``horizon=None`` is the legacy volume-blind gate:
        every positive-gain swap pays.  ``mode`` picks the swap's
        one-time cost in SpMV equivalents (:data:`REPLAN_SPMV_EQUIV`).
        """
        if mode not in REPLAN_SPMV_EQUIV:
            raise ValueError(f"unknown re-plan mode: {mode!r}; expected "
                             f"one of {tuple(REPLAN_SPMV_EQUIV)}")
        equiv = REPLAN_SPMV_EQUIV[mode]
        g = float(gain_frac)
        break_even = equiv / g if g > 0 else float("inf")
        if horizon is None:
            pays = g > 0
        else:
            pays = float(horizon) * max(g, 0.0) >= equiv
        return ReplanDecision(pays=pays, mode=mode, gain_frac=g,
                              horizon=None if horizon is None
                              else float(horizon),
                              break_even_spmvs=break_even)


#: Process-wide default oracle (stateless; machine constants default per
#: call-site shard count).  Every consumer that does not need custom
#: ``EmuConfig`` constants queries this instance.
DEFAULT_ORACLE = CostOracle()
