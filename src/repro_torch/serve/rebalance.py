"""Online hot-spot detection and live re-planning for the SpMV serving path.

The paper's central finding is that distributing work well *once* is not
enough on a migratory-thread machine: sparsity makes threads converge on a
single nodelet over time, and only re-arranging the work restores balance
(§V, Figs. 7-8).  The serving engine had exactly that blind spot — a plan
autotuned at ingest and never revisited while request traffic shifts which
columns are hot.  This module closes the loop:

1. **Monitor** — :class:`LoadMonitor` accumulates per-column activity from
   every served request and folds it through a precomputed column→shard
   attribution map (:func:`~repro_torch.core.migration.shard_load_map`), so each
   observation window costs one matvec, not a matrix walk.
2. **Detect** — the induced per-shard load CV is compared against an
   absolute threshold *and* the ingest-time baseline, with hysteresis
   (``patience`` consecutive hot windows to trip, ``cooldown`` windows of
   grace after a swap) so a single bursty window never thrashes the plan.
3. **Re-plan** — two tiers, cheapest first:

   * **Partial (hot shards only).** Since the per-shard program refactor
     the plan carries a kernel per shard, so the first response to a trip
     is local: re-derive the hot shards' kernels on the
     traffic-thinned structure (:func:`~repro_torch.core.plan._active_submatrix`
     + the :class:`~repro_torch.core.oracle.CostOracle` kernel table against
     the *deployed* partition), gate on the load-weighted kernel-slot
     cost improving by ``min_gain``, and rebuild **only the changed
     stages** (:func:`~repro_torch.core.program.relower` shares every other
     stage with the incumbent program).  No grid, no probes, no full
     rebuild.
   * **Full.** When no hot-shard kernel change pays, :func:`replan`
     reruns the autotuner traffic-weighted (``autotune(...,
     col_weight=...)``) under a budget (restricted reordering grid, small
     Emu-probe count), then uses the cheap vectorized Emu engine as a
     *drift oracle*: both the incumbent and the candidate plan are
     simulated on the traffic-active submatrix, and the candidate must
     win by ``min_gain`` before it is considered.  If the winning base
     matches the incumbent's, the build still goes through ``relower``
     (per-shard double-buffered swap).
4. **Swap** — the candidate program is built double-buffered: in-flight
   ``spmv`` calls keep the old :class:`~repro_torch.core.program.SpmvProgram`
   while the new one is constructed and validated against the exact CSR
   oracle (:func:`~repro_torch.core.sparse_matrix.csr_matvec`) on sample
   vectors; only then does the engine swing its reference (a single
   attribute assignment) and re-attach the monitor.

This is the serving-layer analogue of the paper's reordering win: the
workload decides when the plan is re-derived, not the load-time snapshot.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.emu import EmuConfig
from repro_torch.core.migration import shard_load_map
from repro_torch.core.partition import make_partition
from repro_torch.core.oracle import DEFAULT_ORACLE as _oracle
from repro_torch.core.plan import KERNELS, PlanChoice, RankedPlan, \
    _active_submatrix, _permute_weights, autotune
from repro_torch.core.program import SpmvProgram, lower, relower
from repro_torch.core.reorder import REORDERINGS, reordering_permutation
from repro_torch.core.sparse_matrix import CSRMatrix, csr_matvec
from repro_torch.core.spmv import PLAN_EXCHANGES, SpmvPlan, local_spmv

__all__ = ["RebalanceConfig", "RebalanceEvent", "LoadMonitor", "replan",
           "hot_shards", "probe_plan_seconds", "weighted_shard_load"]


def weighted_shard_load(dist: SpmvProgram,
                        w_caller: np.ndarray) -> np.ndarray:
    """(P,) expected per-shard load of one request on a built program.

    ``w_caller`` is per-column activity in the *caller's* index order; it
    is permuted into the program's (possibly reordered) order and folded
    through :func:`~repro_torch.core.migration.shard_load_map`.  This is the
    single definition of the load-attribution formula — the monitor's
    cached fast path, the re-planner's post-swap CV, and the drift
    benchmark all compute exactly this.
    """
    lm, base = shard_load_map(dist.matrix, dist.partition, dist.x_layout,
                              dist.b_layout)
    w = _permute_weights(w_caller, dist.perm) if dist.perm is not None \
        else w_caller
    return lm @ w + base


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    """Knobs for the monitor → detect → re-plan → swap loop.

    The detector trips when the EMA-smoothed per-shard load CV exceeds
    ``max(cv_trigger, cv_ratio * baseline_cv)`` for ``patience``
    consecutive windows (the baseline is the same metric under uniform
    traffic on the currently-active plan), outside the post-swap
    ``cooldown``.  The re-plan budget is ``probe`` Emu-simulated bases
    over the ``reorderings`` sub-grid; a candidate must beat the incumbent
    by ``min_gain`` (relative, Emu-modeled seconds on the traffic-active
    submatrix) and reproduce :func:`~repro_torch.core.sparse_matrix.csr_matvec`
    on ``validate_samples`` random vectors before it is swapped in.
    """

    window: int = 64
    ema: float = 0.5
    cv_trigger: float = 0.35
    cv_ratio: float = 1.5
    patience: int = 2
    cooldown: int = 4
    probe: int = 2
    reorderings: tuple = REORDERINGS
    min_gain: float = 0.02
    validate_samples: int = 2
    validate_atol: float = 1e-5   # fp32 slabs vs the float64 CSR oracle
    seed: int = 0
    #: A shard is *hot* when its traffic-weighted load exceeds
    #: ``hot_factor`` x the mean — the set the partial re-plan is allowed
    #: to re-kernel.
    hot_factor: float = 1.25
    #: Try the hot-shard-only kernel re-selection before the full
    #: traffic-weighted autotune (no grid, no probes, only the changed
    #: stages rebuilt).  Disable to force every trip through the full
    #: re-plan.
    partial_first: bool = True
    #: Run the re-plan on a daemon worker thread instead of inline in the
    #: request that closed the hot window.  Inline (the default) is
    #: deterministic — the swap has happened by the time ``spmv`` returns —
    #: but charges the full autotune + probe + build + validation to that
    #: one request; async keeps request latency flat and swaps when the
    #: worker finishes (requests served meanwhile use the old program).
    async_replan: bool = False
    #: Asudeh amortization gate (arXiv 2506.10356): project re-plan
    #: amortization over this many future *engine* requests — the router
    #: scales it by the tenant's observed traffic share into the
    #: ``amortization_horizon`` it hands :func:`replan`, and a swap only
    #: goes through when ``horizon * gain`` covers the swap's one-time
    #: cost in SpMV equivalents
    #: (:data:`~repro_torch.core.oracle.REPLAN_SPMV_EQUIV`).  ``None`` (the
    #: default) keeps the legacy volume-blind gate: every swap that
    #: clears ``min_gain`` pays, regardless of traffic volume.
    amortization_lookahead: int | None = None


@dataclasses.dataclass
class RebalanceEvent:
    """One detector trip: what was measured, decided, and (maybe) swapped.

    ``mode`` records which re-plan tier produced the decision:
    ``"partial"`` (hot-shard kernel/exchange re-selection, only
    ``swapped_shards`` stages rebuilt) or ``"full"`` (budgeted
    traffic-weighted autotune).  ``exchange_flips`` lists the shards whose
    exchange policy changed — those need no stage rebuild at all, only
    the device-operand cache (exchange is not a lowering-base field).
    """

    request_index: int
    window_index: int
    old_plan: SpmvPlan
    new_plan: SpmvPlan | None
    load_cv_before: float
    load_cv_after: float | None
    probe_old_seconds: float | None
    probe_new_seconds: float | None
    swapped: bool
    reason: str
    mode: str = "full"
    swapped_shards: tuple = ()
    exchange_flips: tuple = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["old_plan"] = dataclasses.asdict(self.old_plan)
        d["new_plan"] = None if self.new_plan is None else \
            dataclasses.asdict(self.new_plan)
        return d


class LoadMonitor:
    """Per-shard load watcher for one ingested matrix.

    ``observe(x)`` is called on every served request with the request
    vector/block (caller index order).  Activity is |x| accumulated per
    column; when ``cfg.window`` requests have been seen the window closes:
    the window's mean activity is normalized to mean 1 (so uniform dense
    traffic reproduces the static instruction counts), EMA-folded into the
    running estimate, and pushed through the active plan's column→shard
    load map.  ``observe`` returns ``True`` when the hysteresis logic says
    the engine should attempt a re-plan *now*.
    """

    def __init__(self, dist: SpmvProgram, cfg: RebalanceConfig):
        self.cfg = cfg
        self._ncols = dist.matrix.ncols
        self._act_sum = np.zeros(self._ncols, dtype=np.float64)
        self._requests_in_window = 0
        self._act_ema: np.ndarray | None = None
        self._hot_streak = 0
        self._cooldown_left = 0
        self.requests_seen = 0
        self.windows_closed = 0
        self.last_cv = 0.0
        self.trips = 0
        self.attach(dist)

    def attach(self, dist: SpmvProgram) -> None:
        """(Re)bind to the active program; called again after every swap.

        The (load_map, base, perm) triple is swapped in as **one**
        attribute assignment so a concurrent ``observe`` (async re-plan
        worker swapping while request threads serve) never computes a
        load with the new map but the old permutation.
        """
        lm, base = shard_load_map(dist.matrix, dist.partition, dist.x_layout,
                                  dist.b_layout)
        self._bound = (lm, base, dist.perm)
        self.baseline_cv = _cv(lm @ np.ones(self._ncols) + base)
        self.last_cv = self.baseline_cv
        self._hot_streak = 0

    # -- per-request path ---------------------------------------------------

    def observe(self, x: np.ndarray) -> bool:
        """Fold one request (or (N, B) block) in; True => attempt re-plan."""
        a = np.abs(np.asarray(x, dtype=np.float64))
        if a.ndim == 2:
            self._act_sum += a.sum(axis=1)
            self.requests_seen += a.shape[1]
            self._requests_in_window += a.shape[1]
        else:
            self._act_sum += a
            self.requests_seen += 1
            self._requests_in_window += 1
        if self._requests_in_window < self.cfg.window:
            return False
        return self._close_window()

    def _close_window(self) -> bool:
        w = self._act_sum / max(self._requests_in_window, 1)
        mean = w.mean()
        w = w / mean if mean > 0 else np.ones_like(w)
        self._act_sum = np.zeros(self._ncols, dtype=np.float64)
        self._requests_in_window = 0
        self.windows_closed += 1

        e = self.cfg.ema
        self._act_ema = w if self._act_ema is None else \
            e * self._act_ema + (1.0 - e) * w
        # Detection runs on the *instantaneous* window CV — ``patience``
        # then genuinely means "this many consecutive hot windows", and a
        # single burst cannot bleed into the streak through the EMA.  The
        # EMA (reported as last_cv, and handed to the re-planner) smooths
        # the weights the new plan is derived from.
        window_cv = _cv(self._shard_load_for(w))
        self.last_cv = _cv(self.shard_load())

        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._hot_streak = 0
            return False
        threshold = max(self.cfg.cv_trigger,
                        self.cfg.cv_ratio * self.baseline_cv)
        if window_cv > threshold:
            self._hot_streak += 1
        else:
            self._hot_streak = 0
        if self._hot_streak >= self.cfg.patience:
            self._hot_streak = 0
            self.trips += 1
            return True
        return False

    # -- read-side ----------------------------------------------------------

    def activity(self) -> np.ndarray:
        """Current EMA per-column activity (caller order, mean 1)."""
        if self._act_ema is None:
            return np.ones(self._ncols, dtype=np.float64)
        return self._act_ema

    def shard_load(self) -> np.ndarray:
        """(P,) expected per-shard load of one request under current traffic.

        The activity estimate lives in caller index order; the active
        program may be reordered, so the weights are permuted into the
        program's order before hitting the load map.
        """
        return self._shard_load_for(self.activity())

    def _shard_load_for(self, w_caller: np.ndarray) -> np.ndarray:
        # Cached-map fast path of :func:`weighted_shard_load` (one window
        # = one matvec); the triple is read in one statement for the same
        # atomicity reason attach() writes it in one.
        lm, base, perm = self._bound
        w = _permute_weights(w_caller, perm) if perm is not None else w_caller
        return lm @ w + base

    def cooldown(self) -> None:
        """Start the post-swap (or post-rejected-replan) grace period."""
        self._cooldown_left = self.cfg.cooldown
        self._hot_streak = 0

    def stats(self) -> dict:
        return {"requests_seen": self.requests_seen,
                "windows_closed": self.windows_closed,
                "baseline_cv": round(self.baseline_cv, 6),
                "last_cv": round(self.last_cv, 6),
                "trips": self.trips}


def _cv(v: np.ndarray) -> float:
    mu = v.mean()
    return float(v.std() / mu) if mu else 0.0


def probe_plan_seconds(csr: CSRMatrix, plan: SpmvPlan,
                       col_weight: np.ndarray,
                       emu: EmuConfig | None = None) -> float:
    """Emu-modeled seconds for one SpMV of ``plan`` under observed traffic.

    The drift oracle: the matrix is reordered per the plan, restricted to
    the traffic-active columns
    (:func:`~repro_torch.core.plan._active_submatrix`), and run through the
    vectorized Emu timeline engine with the plan's partition/layout — a
    millisecond-cheap measurement of how the *deployed* program handles
    the traffic the monitor actually saw.  The probe goes through
    :meth:`~repro_torch.core.oracle.CostOracle.probe` with the plan's per-shard
    kernels, so the tick machine replays each shard's *format-shaped*
    instruction stream (seg carry chains, hyb overflow scatter, split
    combine) — kernel differences now show up in measured seconds instead
    of being invisible to the probe.
    """
    emu = emu or EmuConfig(nodelets=plan.num_shards)
    # Thin once in caller order (identical entry set for every plan being
    # compared), then permute the thinned matrix alongside the plan.
    sub = _active_submatrix(csr, np.asarray(col_weight, np.float64))
    perm = reordering_permutation(csr, plan.reordering, seed=plan.seed,
                                  parts=plan.num_shards)
    if plan.reordering == "none":
        A, sub_r = csr, sub
    else:
        A = csr.permuted(perm, perm)
        sub_r = sub.permuted(perm, perm)
    # The partition is the deployed one: cut on the full matrix, probed on
    # the traffic it actually serves.
    part = make_partition(A, plan.num_shards, plan.distribution)
    res = _oracle.probe(sub_r, part, plan, emu=emu)
    return float(res.seconds)


def hot_shards(load: np.ndarray, factor: float) -> np.ndarray:
    """Shards whose load exceeds ``factor`` x the mean (the partial
    re-plan's working set)."""
    mu = load.mean()
    if mu <= 0:
        return np.zeros(0, dtype=np.int64)
    return np.flatnonzero(load > factor * mu)


def _validated(dist: SpmvProgram, csr: CSRMatrix, cfg: RebalanceConfig,
               request_index: int) -> bool:
    """Candidate program reproduces the exact CSR oracle on sample vectors."""
    rng = np.random.default_rng(cfg.seed + request_index)
    for _ in range(cfg.validate_samples):
        xs = rng.standard_normal(csr.ncols)
        if not np.allclose(local_spmv(dist, xs), csr_matvec(csr, xs),
                           atol=cfg.validate_atol, rtol=1e-5):
            return False
    return True


def _try_partial_replan(csr: CSRMatrix, monitor: LoadMonitor,
                        current: PlanChoice, program: SpmvProgram,
                        w: np.ndarray, cfg: RebalanceConfig,
                        request_index: int,
                        amortization_horizon: float | None = None):
    """Hot-shard-only kernel/exchange re-selection; None when inapplicable.

    Two independent axes, each with its own gate:

    * **Kernel.**  The hot shards' kernels are re-derived from the
      *traffic-thinned* structure (:func:`~repro_torch.core.plan._active_submatrix`
      permuted into the deployed program's order) against the **deployed**
      partition — the format each hot shard would want for the entries the
      request stream actually touches.  The gate is the load-weighted
      kernel-slot cost (sum over shards of ``load_p * cost[kernel_p][p]``)
      improving by ``cfg.min_gain``; the Emu drift oracle cannot see
      kernels, so the analytic table is the authoritative metric here.
      The candidate grid is the full :data:`~repro_torch.core.plan.KERNELS` —
      including the split-nnz two-stage ``split`` family, so a shard that
      drifted onto a monster-row hot-spot can be swapped onto split
      partials without a full re-plan (the split count re-derives from
      :func:`~repro_torch.core.plan.split_meta` at relower time), and the
      bitmask-tiled ``tile`` family, so a shard whose hot traffic
      concentrates on a banded/blocked substructure swaps onto dense
      tile streams the same way.  Exact cost ties break by the shard's
      bottleneck class
      (:meth:`~repro_torch.core.oracle.CostOracle.kernel_affinity`).  ``split`` is
      only offered to a hot shard when the *thinned* structure still has
      a row spanning at least ``SPLIT_MIN_SPAN`` seg chunks
      (:meth:`~repro_torch.core.oracle.CostOracle.split_span_ok`): heavy
      thinning of a mildly-skewed stream can shorten a monster row below
      the span floor, and a split chosen on that table would deploy a
      pure-overhead stage 2 against the real matrix.
    * **Exchange.**  The hot shards' exchange policies are re-derived the
      same way from the oracle's exchange table on the
      thinned structure, gated on the load-weighted exchange cost
      improving by ``cfg.min_gain``.  A flip rebuilds **no** stages at
      all — exchange is not a lowering-base field, so ``relower`` shares
      every stage and only the device-operand cache is re-derived.

    An axis whose gate fails is reverted; the partial tier applies
    whichever axes survive (``None`` when neither does).  Only the
    kernel-changed stages are rebuilt (:func:`~repro_torch.core.program.relower`)
    and the candidate must still reproduce ``csr_matvec`` before the swap.
    """
    old_plan = current.plan
    if old_plan.num_shards != program.plan.num_shards:
        return None
    load = monitor.shard_load()
    hot = hot_shards(load, cfg.hot_factor)
    if hot.size == 0 or hot.size >= load.size:
        return None
    sub = _active_submatrix(csr, w, seed=cfg.seed)
    if sub is csr:
        return None                       # uniform traffic: nothing local
    sub_r = sub if program.perm is None else \
        sub.permuted(program.perm, program.perm)

    # -- kernel axis --------------------------------------------------------
    costs = _oracle.kernel_costs(sub_r, program.partition)
    old_k = old_plan.resolved_shard_kernels()
    new_k = list(old_k)
    sbn = current.shard_bottlenecks
    for p in hot:
        # Ties break by the hot shard's bottleneck-class affinity (a
        # bandwidth-bound shard leans tile/ell streaming, an
        # imbalance-bound one split/seg) — order only, never a flip of a
        # strict cost winner.
        order = KERNELS if sbn is None else \
            _oracle.kernel_affinity(sbn[p])
        kerns = order if _oracle.split_span_ok(sub_r, program.partition,
                                               int(p)) \
            else tuple(k for k in order if k != "split")
        new_k[p] = min(kerns, key=lambda k: (costs[k][p],
                                             kerns.index(k)))
    kernel_ok = tuple(new_k) != tuple(old_k)
    if kernel_ok:
        old_c = float(sum(load[p] * costs[k][p]
                          for p, k in enumerate(old_k)))
        new_c = float(sum(load[p] * costs[k][p]
                          for p, k in enumerate(new_k)))
        if not new_c < (1.0 - cfg.min_gain) * max(old_c, 1e-30):
            kernel_ok = False
    if not kernel_ok:
        new_k = list(old_k)

    # -- exchange axis ------------------------------------------------------
    ex_costs = _oracle.exchange_costs(sub_r, program.partition,
                                      layout=old_plan.layout)
    old_e = old_plan.resolved_shard_exchanges()
    new_e = list(old_e)
    for p in hot:
        new_e[p] = min(PLAN_EXCHANGES,
                       key=lambda e: (ex_costs[e][p],
                                      PLAN_EXCHANGES.index(e)))
    ex_ok = tuple(new_e) != tuple(old_e)
    if ex_ok:
        old_ec = float(sum(load[p] * ex_costs[e][p]
                           for p, e in enumerate(old_e)))
        new_ec = float(sum(load[p] * ex_costs[e][p]
                           for p, e in enumerate(new_e)))
        if not new_ec < (1.0 - cfg.min_gain) * max(old_ec, 1e-30):
            ex_ok = False
    if not ex_ok:
        new_e = list(old_e)

    if not (kernel_ok or ex_ok):
        return None

    # Asudeh amortization gate: even a relower-only swap has a one-time
    # cost; at low projected volume it never pays back.
    num = den = 0.0
    if kernel_ok:
        num += old_c - new_c
        den += old_c
    if ex_ok:
        num += old_ec - new_ec
        den += old_ec
    gain = num / max(den, 1e-30)
    if not _oracle.replan_pays(gain, amortization_horizon,
                               mode="partial").pays:
        return None                       # fall through to the full tier

    new_plan = old_plan
    if kernel_ok:
        new_plan = dataclasses.replace(new_plan, shard_kernels=tuple(new_k))
    if ex_ok:
        if len(set(new_e)) == 1:          # flips converged on one policy
            new_plan = dataclasses.replace(new_plan, exchange=new_e[0],
                                           shard_exchanges=None)
        else:
            new_plan = dataclasses.replace(new_plan,
                                           shard_exchanges=tuple(new_e))

    dist = relower(program, new_plan)
    if not _validated(dist, csr, cfg, request_index):
        return None                       # fall through to the full tier
    changed = tuple(int(p) for p in range(len(old_k))
                    if new_k[p] != old_k[p])
    flips = tuple(int(p) for p in range(len(old_e))
                  if new_e[p] != old_e[p])
    choice = PlanChoice(
        features=current.features,
        ranking=(RankedPlan(plan=new_plan,
                            cost=_oracle.plan_cost(csr, new_plan)),),
        probed=0, shard_features=current.shard_features,
        bottleneck=current.bottleneck,
        shard_bottlenecks=current.shard_bottlenecks)
    parts = []
    if kernel_ok:
        parts.append(
            f"re-lowered hot shard(s) {list(changed)} "
            f"({'/'.join(old_k[p] for p in changed)} -> "
            f"{'/'.join(new_k[p] for p in changed)}), weighted kernel cost "
            f"{(1.0 - new_c / max(old_c, 1e-30)):.1%} down")
    if ex_ok:
        parts.append(
            f"flipped exchange on shard(s) {list(flips)} "
            f"({'/'.join(old_e[p] for p in flips)} -> "
            f"{'/'.join(new_e[p] for p in flips)}), weighted exchange cost "
            f"{(1.0 - new_ec / max(old_ec, 1e-30)):.1%} down")
    event = RebalanceEvent(
        request_index=request_index, window_index=monitor.windows_closed,
        old_plan=old_plan, new_plan=new_plan,
        load_cv_before=monitor.last_cv,
        load_cv_after=_cv(weighted_shard_load(dist, w)),
        probe_old_seconds=None, probe_new_seconds=None,
        swapped=True, mode="partial", swapped_shards=changed,
        exchange_flips=flips,
        reason="partial: " + "; ".join(parts))
    return dist, choice, event


def replan(csr: CSRMatrix, monitor: LoadMonitor, current: PlanChoice, *,
           num_shards: int, seed: int, cfg: RebalanceConfig,
           request_index: int, program: SpmvProgram | None = None,
           amortization_horizon: float | None = None
           ) -> tuple[SpmvProgram | None, PlanChoice | None,
                      RebalanceEvent]:
    """Budgeted traffic-weighted re-plan with oracle gate + validated build.

    Two tiers.  With ``cfg.partial_first`` and the deployed ``program``
    supplied, the hot-shard-only kernel re-selection
    (:func:`_try_partial_replan`) runs first — when it pays, only the hot
    shards' stages are rebuilt and swapped.  Otherwise the full budgeted
    autotune runs (traffic-weighted grid + Emu drift oracle); when its
    winner shares the incumbent's base the build still goes through
    :func:`~repro_torch.core.program.relower`, so even full re-plans reuse every
    unchanged stage.

    ``amortization_horizon`` (projected SpMVs the tenant will issue
    against the new plan; the router derives it from per-tenant traffic
    stats and ``cfg.amortization_lookahead``) arms the Asudeh gate: each
    tier's swap must additionally satisfy
    :meth:`~repro_torch.core.oracle.CostOracle.replan_pays` — a positive-gain
    swap a volume-blind model would take is refused when the projected
    volume cannot amortize its one-time cost.  ``None`` (the default)
    keeps the legacy volume-blind behavior.

    Returns ``(new_dist, new_choice, event)``; the first two are ``None``
    when the re-plan was rejected (plan unchanged, no modeled gain, or
    validation failure) — the caller keeps serving the old program either
    way, which is what makes the swap double-buffered.
    """
    w = monitor.activity()
    cv_before = monitor.last_cv

    if cfg.partial_first and program is not None:
        partial = _try_partial_replan(csr, monitor, current, program, w,
                                      cfg, request_index,
                                      amortization_horizon)
        if partial is not None:
            return partial

    choice = autotune(csr, num_shards=num_shards, seed=seed,
                      probe=cfg.probe, reorderings=cfg.reorderings,
                      col_weight=w)
    new_plan = choice.plan
    old_plan = current.plan

    def rejected(reason: str, old_s=None, new_s=None) -> tuple:
        return None, None, RebalanceEvent(
            request_index=request_index, window_index=monitor.windows_closed,
            old_plan=old_plan, new_plan=new_plan,
            load_cv_before=cv_before, load_cv_after=None,
            probe_old_seconds=old_s, probe_new_seconds=new_s,
            swapped=False, reason=reason)

    if new_plan == old_plan:
        return rejected("re-plan chose the incumbent plan")

    old_s = probe_plan_seconds(csr, old_plan, w)
    new_s = probe_plan_seconds(csr, new_plan, w)
    # Exchange is deliberately NOT a base field: flipping it re-lowers
    # cheaply (every stage shared, only device operands rebuilt), so a
    # kernel- or exchange-only winner goes through relower below.
    same_base = all(getattr(new_plan, f) == getattr(old_plan, f)
                    for f in ("layout", "distribution", "reordering",
                              "num_shards", "seed"))
    if same_base:
        # The format-aware Emu probe can separate same-base candidates
        # too, but the traffic-weighted analytic model stays the
        # authoritative same-base gate (cheaper, and pinned by the
        # frozen-fixture suite); the probe gates across bases.
        old_t = _oracle.plan_cost(csr, old_plan, col_weight=w).total
        new_t = _oracle.plan_cost(csr, new_plan, col_weight=w).total
        if new_t > (1.0 - cfg.min_gain) * old_t:
            return rejected("analytic model: no modeled gain over incumbent "
                            "(same base)", old_s, new_s)
        gain = 1.0 - new_t / max(old_t, 1e-30)
    elif new_s > (1.0 - cfg.min_gain) * old_s:
        return rejected("drift oracle: no modeled gain over incumbent",
                        old_s, new_s)
    else:
        gain = 1.0 - new_s / max(old_s, 1e-30)

    decision = _oracle.replan_pays(gain, amortization_horizon, mode="full")
    if not decision.pays:
        return rejected(
            f"amortization gate: modeled gain {gain:.1%} needs "
            f"{decision.break_even_spmvs:.0f} SpMVs to pay off, but the "
            f"projected horizon is {amortization_horizon:.0f}",
            old_s, new_s)

    # Double-buffered build: the old program keeps serving until the new
    # one exists and reproduces the exact CSR oracle.  Same-base winners
    # re-lower only the stages whose kernel changed.
    if same_base and program is not None:
        dist = relower(program, new_plan)
    else:
        dist = lower(csr, new_plan)
    if not _validated(dist, csr, cfg, request_index):
        return rejected("validation failed: candidate program does not "
                        "reproduce csr_matvec", old_s, new_s)

    old_k = old_plan.resolved_shard_kernels()
    new_k = new_plan.resolved_shard_kernels()
    changed = tuple(int(p) for p in range(num_shards)
                    if p >= len(old_k) or new_k[p] != old_k[p]) \
        if same_base else tuple(range(num_shards))
    old_e = old_plan.resolved_shard_exchanges()
    new_e = new_plan.resolved_shard_exchanges()
    flips = tuple(int(p) for p in range(num_shards)
                  if p >= len(old_e) or new_e[p] != old_e[p])
    cv_after = _cv(weighted_shard_load(dist, w))
    event = RebalanceEvent(
        request_index=request_index, window_index=monitor.windows_closed,
        old_plan=old_plan, new_plan=new_plan,
        load_cv_before=cv_before, load_cv_after=cv_after,
        probe_old_seconds=old_s, probe_new_seconds=new_s,
        swapped=True, mode="full", swapped_shards=changed,
        exchange_flips=flips,
        reason="swapped: modeled gain "
        f"{(1.0 - new_s / max(old_s, 1e-30)):.1%}")
    return dist, choice, event
