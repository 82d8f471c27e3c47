"""Multi-tenant SpMV serving router with persistent warm-start artifacts.

One :class:`SparseMatrixEngine` hosts *many* ingested matrices behind a
single ``spmv(name, x)`` entry point.  Three fleet-scale behaviours live
here (the single-matrix mechanics — autotune, lowering, rebalance — are
unchanged from the drift-aware engine this router refactors):

* **Warm-start ingest** (``artifact_dir=``): every cold ingest persists
  its lowered :class:`~repro_torch.core.program.SpmvProgram` as a versioned
  bundle (:mod:`repro_torch.core.artifacts`); a later ingest of the same bytes
  — typically a process restart — digest-hits the bundle and skips the
  autotune grid, the Emu probe *and* the re-lower, loading device-ready
  slabs whose ``execute()`` outputs are bitwise identical to a fresh
  lower.  Any mismatch (schema bump, changed values) silently falls back
  to the cold path.
* **Per-tenant rebalance state**: each tenant gets its own
  :class:`~repro_torch.serve.rebalance.RebalanceConfig` (``ingest(...,
  rebalance=)`` overrides the engine default) and
  :class:`~repro_torch.serve.rebalance.LoadMonitor`, so a bursty tenant's
  re-plans never reset a stable tenant's baselines.  A rebalance swap
  atomically invalidates and rewrites the tenant's artifact (manifest
  removed first, rewritten last), so disk never disagrees with the live
  program: a restart warm-loads the *post-drift* plan.
* **Cross-request micro-batching** (``micro_batch=``): concurrent
  single-vector requests for the same tenant are gathered — leader /
  follower, bounded by ``max_batch``/``max_wait_ms`` — into one
  multi-RHS ``(N, B)`` execute, whose columns are bitwise-equal to
  per-vector calls (the batched-numpy invariant the tests pin), then
  scattered back to each waiter.

Port of ``repro.serve.router`` with one addition, where requests run:
``backend="device"`` (the default) answers on ``device`` (CUDA unless
``device="cpu"``) through one executor per tenant
(:func:`~repro_torch.core.program.make_program_spmv_fn`), built at
ingest, at warm start and for every swapped-in program, its operands
uploaded once and, on CUDA, each x shape replayed as a CUDA graph (the
counterpart of the reference's ``jax.jit``; the micro-batch shapes are
captured when the executor is built); answers are float32.
``backend="numpy"`` is the reference's float64 path, bitwise.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.artifacts import ArtifactError, load_program, save_program
from repro_torch.core.plan import PlanCache, PlanChoice, autotune, feature_key
from repro_torch.core.program import MAX_GRAPHS, SpmvProgram, \
    device_spmv, execute, lower, make_program_spmv_fn, resolve_device
from repro_torch.core.sparse_matrix import CSRMatrix
from repro_torch.core.spmv import SpmvPlan
from repro_torch.serve.rebalance import LoadMonitor, RebalanceConfig, \
    RebalanceEvent, replan

__all__ = ["SparseMatrixEngine", "IngestedMatrix", "MicroBatchConfig"]


@dataclasses.dataclass(frozen=True)
class MicroBatchConfig:
    """Cross-request micro-batching knobs.

    The first request to arrive for an idle tenant becomes the *leader*:
    it waits up to ``max_wait_ms`` (polling every ``poll_ms``) for up to
    ``max_batch - 1`` followers, runs one batched ``(N, B)`` execute, and
    hands each follower its column.  ``max_wait_ms=0`` still batches
    whatever is already queued — pure piggybacking with no added latency.
    """

    max_batch: int = 8
    max_wait_ms: float = 2.0
    poll_ms: float = 0.1


class _MicroBatcher:
    """Leader/follower gatherer for one tenant (thread-safe)."""

    def __init__(self, cfg: MicroBatchConfig, compute):
        self.cfg = cfg
        self._compute = compute          # (N, B) ndarray, n_requests -> (M, B)
        self._lock = threading.Lock()
        self._pending: list = []         # (x, slot, event)
        self._leading = False
        self.batches = 0
        self.requests = 0
        self.widest = 0

    def submit(self, x: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        evt = threading.Event()
        slot: dict = {}
        with self._lock:
            self._pending.append((x, slot, evt))
            self.requests += 1
            lead = not self._leading
            if lead:
                self._leading = True
        if not lead:
            if not evt.wait(timeout):
                raise RuntimeError("micro-batch leader never delivered "
                                   f"within {timeout}s")
            if "err" in slot:
                raise slot["err"]
            return slot["y"]
        # Leader: linger for followers, then drain in max_batch waves until
        # the queue is empty (arrivals during compute join the next wave
        # rather than electing a second leader).
        deadline = time.monotonic() + self.cfg.max_wait_ms / 1e3
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._pending) >= self.cfg.max_batch:
                    break
            time.sleep(self.cfg.poll_ms / 1e3)
        while True:
            with self._lock:
                batch = self._pending[: self.cfg.max_batch]
                del self._pending[: self.cfg.max_batch]
                if not batch:
                    self._leading = False
                    break
            try:
                X = np.stack([b[0] for b in batch], axis=1)
                Y = self._compute(X, len(batch))
            except BaseException as err:
                # Fail every waiter (drained and still-queued) rather than
                # leaving followers blocked on a dead leader.
                with self._lock:
                    batch += self._pending
                    self._pending.clear()
                    self._leading = False
                for _, s, e in batch:
                    s["err"] = err
                    e.set()
                raise
            self.batches += 1
            self.widest = max(self.widest, len(batch))
            for i, (_, s, e) in enumerate(batch):
                s["y"] = Y[:, i]
                e.set()
        return slot["y"]

    def stats(self) -> dict:
        return {"requests": self.requests, "batches": self.batches,
                "widest": self.widest}


@dataclasses.dataclass
class IngestedMatrix:
    """One served tenant: its autotuned choice + device-ready program.

    ``csr`` keeps the original (caller-order) matrix so the rebalancer
    can re-derive plans (and the artifact rewrite can re-digest) against
    it; ``monitor``/``rebalance_log`` exist only for tenants with
    rebalancing enabled.  ``plan_cache_hit`` records that ingest skipped
    the autotune grid via the feature-keyed plan cache; ``warm_start``
    that it skipped autotune *and* lowering via an artifact digest hit.
    """

    name: str
    choice: PlanChoice
    dist: SpmvProgram
    # Original caller-order matrix, kept only when rebalancing is enabled
    # (the re-planner re-derives plans from it); None otherwise so a
    # plain serving engine doesn't pin a second copy of every matrix.
    csr: CSRMatrix | None = None
    spmv_count: int = 0
    plan_cache_hit: bool = False
    warm_start: bool = False
    bundle_dir: str | None = None
    rebalance_cfg: RebalanceConfig | None = None
    monitor: LoadMonitor | None = None
    rebalance_log: List[RebalanceEvent] = dataclasses.field(
        default_factory=list)
    replan_thread: threading.Thread | None = None
    replan_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)
    batcher: _MicroBatcher | None = None
    #: ``backend="device"``: the executor serving ``dist`` (``executor.
    #: program``; requests read the pair through this one attribute) and
    #: the seconds its operand build and upload took.
    executor: object | None = None
    executor_build_s: float = 0.0


class SparseMatrixEngine:
    """Multi-tenant serving router for SpMV: ingest once, serve many.

    ``ingest`` runs the cost-model autotuner (with Emu-simulator probe
    re-ranking by default; pass ``probe=0`` to opt out, or
    ``probe="auto"`` to spend probes adaptively until the
    measured-vs-analytic inversion rate stabilizes) and lowers the
    winning plan — unless a warm path answers first, in cheapness order:

    1. **artifact store** (``artifact_dir=``): same-bytes digest hit
       loads the previously lowered program — no autotune, no lower;
    2. **plan cache** (on by default; ``plan_cache_dir=`` makes it
       disk-backed and shared across engine instances): a structurally
       similar matrix (equal :func:`~repro_torch.core.plan.feature_key`)
       reuses the previously autotuned plan — no autotune, fresh lower.

    ``spmv`` answers y = A @ x requests — ``x`` a single (N,) vector or
    a multi-RHS block (N, B) — in the caller's original index order;
    with ``micro_batch=`` enabled, concurrent single-vector requests for
    one tenant share a batched execute.  ``plans()`` exposes every
    decision as JSON so an operator can audit *why* a tenant got its
    layout/kernel; ``stats()`` adds per-tenant serving counters.

    Per-tenant rebalancing (``rebalance=`` engine-wide default,
    overridable per ingest) watches each tenant's request mix and swaps
    validated re-plans in double-buffered (``serve/rebalance.py``); a
    swap rewrites the tenant's artifact so restarts resume the new plan.

    ``backend="device"`` serves on ``device`` through a per-tenant
    executor (graph-replayed on CUDA; ``device="cuda"`` without a GPU
    raises here); ``backend="numpy"`` runs the reference's float64 host
    executor.
    """

    def __init__(self, *, num_shards: int = 8,
                 probe: int | str | None = None,
                 seed: int = 0,
                 rebalance: RebalanceConfig | bool | None = None,
                 plan_cache: bool = True,
                 plan_cache_dir: str | None = None,
                 artifact_dir: str | None = None,
                 micro_batch: MicroBatchConfig | bool | None = None,
                 backend: str = "device", device="cuda"):
        if backend not in ("device", "numpy"):
            raise ValueError(f"unknown serving backend {backend!r}; "
                             f"expected 'device' or 'numpy'")
        self.backend = backend
        self.device = resolve_device(device) if backend == "device" \
            else None
        self.num_shards = num_shards
        self.probe = probe
        self.seed = seed
        if rebalance is True:
            rebalance = RebalanceConfig()
        self.rebalance_cfg: RebalanceConfig | None = rebalance or None
        if micro_batch is True:
            micro_batch = MicroBatchConfig()
        self.micro_batch: MicroBatchConfig | None = micro_batch or None
        self._matrices: Dict[str, IngestedMatrix] = {}
        self._plan_cache: PlanCache | None = \
            PlanCache(plan_cache_dir) if (plan_cache or plan_cache_dir) \
            else None
        self.artifact_dir = artifact_dir
        self.plan_cache_hits = 0
        self.warm_starts = 0
        self.artifact_write_errors = 0
        #: Engine-wide served-request count — the denominator of each
        #: tenant's traffic share, which scales the amortization horizon
        #: the re-plan gate sees (``RebalanceConfig.amortization_lookahead``).
        self.total_requests = 0

    # -- ingest ------------------------------------------------------------

    def _bundle_dir(self, name: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", name)
        if safe != name:
            # collision-proof distinct raw names that sanitize identically
            safe += "-" + hashlib.sha256(name.encode()).hexdigest()[:8]
        return os.path.join(self.artifact_dir, safe)

    def _warm_ingest(self, name: str, csr: CSRMatrix):
        """Artifact-path ingest: (program, choice, bundle_dir) or None."""
        if self.artifact_dir is None:
            return None
        bundle = self._bundle_dir(name)
        try:
            prog, choice = load_program(bundle, expect=csr)
        except ArtifactError:
            return None
        if prog.plan.num_shards != self.num_shards:
            return None                # deployment reshaped: re-lower cold
        if choice is None:
            from repro_torch.core.oracle import DEFAULT_ORACLE as oracle
            from repro_torch.core.plan import RankedPlan, extract_features
            features = extract_features(csr, num_shards=self.num_shards)
            choice = PlanChoice(
                features=features,
                ranking=(RankedPlan(plan=prog.plan,
                                    cost=oracle.plan_cost(csr, prog.plan)),),
                probed=0, bottleneck=oracle.classify(features))
        return prog, choice, bundle

    def ingest(self, name: str, csr: CSRMatrix,
               plan: SpmvPlan | None = None, *,
               rebalance: RebalanceConfig | bool | None = None
               ) -> PlanChoice:
        """Register ``csr`` under ``name`` with a load-time-tuned plan.

        Pass an explicit ``plan`` to bypass the autotuner (the choice is
        then recorded as a single-candidate ranking with its model cost).
        The engine's shard count is authoritative: an explicit plan is
        re-targeted to ``self.num_shards`` so the built program, its cost,
        and the recorded features all describe the same deployment.
        Re-ingesting a name replaces the previous tenant.

        ``rebalance`` overrides the engine-wide default for this tenant:
        a :class:`RebalanceConfig` (or ``True`` for defaults) enables it,
        ``False`` disables it, ``None`` inherits the engine default.

        With ``artifact_dir`` set, a digest-identical re-ingest warm
        starts from the saved bundle (no autotune, no lower) and a cold
        ingest persists its program for the next restart.
        """
        from repro_torch.core.oracle import DEFAULT_ORACLE as oracle
        from repro_torch.core.plan import RankedPlan, extract_features
        if rebalance is None:
            rebalance = self.rebalance_cfg
        elif rebalance is True:
            rebalance = RebalanceConfig()
        elif rebalance is False:
            rebalance = None

        warm = None if plan is not None else self._warm_ingest(name, csr)
        cache_hit = False
        bundle = None
        if warm is not None:
            dist, choice, bundle = warm
            self.warm_starts += 1
        else:
            features = extract_features(csr, num_shards=self.num_shards)
            cache_key = (feature_key(features), self.num_shards)
            if plan is None and self._plan_cache is not None:
                cached = self._plan_cache.get(cache_key)
                if cached is not None:
                    plan = cached
                    cache_hit = True
                    self.plan_cache_hits += 1
            if plan is None:
                choice = autotune(csr, num_shards=self.num_shards,
                                  seed=self.seed, probe=self.probe)
                if self._plan_cache is not None:
                    self._plan_cache.put(cache_key, choice.plan)
            else:
                # retarget (not replace): a per-shard kernel tuple tuned
                # for a different shard count is dropped rather than kept
                # unlowerable.
                plan = plan.retarget(self.num_shards)
                choice = PlanChoice(
                    features=features,
                    ranking=(RankedPlan(plan=plan,
                                        cost=oracle.plan_cost(csr, plan)),),
                    probed=0, bottleneck=oracle.classify(features))
            dist = lower(csr, choice.plan)
            if self.artifact_dir is not None:
                bundle = self._bundle_dir(name)
                try:
                    save_program(dist, bundle, source=csr, choice=choice)
                except OSError:
                    self.artifact_write_errors += 1
                    bundle = None
        monitor = LoadMonitor(dist, rebalance) \
            if rebalance is not None else None
        executor, build_s = self._executor(dist, self._batch_shapes(dist))
        m = IngestedMatrix(
            name=name, choice=choice, dist=dist,
            csr=csr if monitor is not None else None,
            plan_cache_hit=cache_hit, warm_start=warm is not None,
            bundle_dir=bundle, rebalance_cfg=rebalance, monitor=monitor,
            executor=executor, executor_build_s=build_s)
        if self.micro_batch is not None:
            m.batcher = _MicroBatcher(
                self.micro_batch,
                lambda X, n, _m=m: self._serve_block(_m, X, n))
        self._matrices[name] = m
        return choice

    def _batch_shapes(self, dist: SpmvProgram) -> list:
        """The x shapes micro-batches of 1..max_batch requests give the
        executor, captured at build so no request waits on a capture."""
        if self.micro_batch is None:
            return []
        S = dist.plan.num_shards
        per = dist.x_layout.padded_length() // S
        return [(S, per, b) for b in
                range(1, min(self.micro_batch.max_batch, MAX_GRAPHS) + 1)]

    def _executor(self, dist: SpmvProgram, shapes=()):
        """``(executor, build seconds)`` for ``dist`` on the device backend
        (graph-replayed on CUDA, ``shapes`` captured now), else
        ``(None, 0.0)``.  Every program object gets its own operands: a
        relowered program shares stage objects, never device tensors."""
        if self.backend != "device":
            return None, 0.0
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        fn = make_program_spmv_fn(dist, device=self.device, graphs=cuda)
        if cuda:
            torch.cuda.synchronize(self.device)
        build_s = time.perf_counter() - t0
        fn.prime(shapes)
        return fn, build_s

    # -- serving -----------------------------------------------------------

    def _lookup(self, name: str) -> IngestedMatrix:
        m = self._matrices.get(name)
        if m is None:
            raise KeyError(
                f"no matrix ingested under {name!r}; ingested names: "
                f"{sorted(self._matrices) or '(none)'} — call "
                f"engine.ingest({name!r}, csr) first")
        return m

    def _serve_block(self, m: IngestedMatrix, x: np.ndarray,
                     n_requests: int = 1) -> np.ndarray:
        if self.backend == "device":
            y = device_spmv(m.executor, x)
        else:
            y = execute(m.dist, x)
        m.spmv_count += n_requests
        self.total_requests += n_requests
        if m.monitor is not None and m.monitor.observe(x):
            self._try_rebalance(m)
        return y

    def spmv(self, name: str, x: np.ndarray) -> np.ndarray:
        """y = A @ x for the ingested tenant ``name`` (original order).

        ``x``: (N,) or multi-RHS (N, B) → (M,) or (M, B); batched columns
        are bitwise-equal to per-vector calls — which is also why
        micro-batched single-vector requests (``micro_batch=``) return
        exactly what a solo call would.  Unknown names raise an
        actionable :class:`KeyError` *before* any stats are touched, so
        ``stats()`` counts successful calls only.
        """
        m = self._lookup(name)
        if m.batcher is not None and np.ndim(x) == 1:
            return m.batcher.submit(np.asarray(x))
        return self._serve_block(m, x)

    # -- rebalancing -------------------------------------------------------

    def _try_rebalance(self, m: IngestedMatrix) -> None:
        """Detector tripped: budgeted re-plan, validated double-buffered swap.

        Callers keep reading ``m.dist`` (the old program) until the
        candidate is built and validated; the swap itself is one attribute
        rebind (atomic under the GIL).  Rejected candidates only start the
        monitor's cooldown — serving never degrades on a failed re-plan.

        With ``async_replan`` the whole re-plan runs on a daemon worker
        thread and this method returns immediately — requests served in
        the meantime use the old program, and at most one worker per
        tenant is in flight.  The default is inline (deterministic, but
        the triggering request absorbs the re-plan latency).
        """
        if m.rebalance_cfg.async_replan:
            # check-then-spawn under the per-tenant lock: two request
            # threads closing hot windows near-simultaneously must not
            # both launch workers.
            with m.replan_lock:
                if m.replan_thread is not None and m.replan_thread.is_alive():
                    return             # a re-plan is already in flight
                m.replan_thread = threading.Thread(
                    target=self._replan_and_swap, args=(m,), daemon=True)
                m.replan_thread.start()
        else:
            self._replan_and_swap(m)

    def _amortization_horizon(self, m: IngestedMatrix) -> float | None:
        """Projected SpMVs tenant ``m`` will issue against a new plan.

        The Asudeh gate's volume estimate: the tenant's observed share of
        engine traffic, projected over the next
        ``cfg.amortization_lookahead`` engine requests.  A tenant taking
        2% of a 1000-request lookahead projects 20 SpMVs — not enough to
        amortize a full re-plan — while a tenant taking 60% projects 600.
        ``None`` (lookahead unset) keeps the legacy volume-blind gate.
        """
        lookahead = m.rebalance_cfg.amortization_lookahead
        if lookahead is None:
            return None
        share = m.spmv_count / max(self.total_requests, 1)
        return float(lookahead) * share

    def _replan_and_swap(self, m: IngestedMatrix) -> None:
        new_dist, new_choice, event = replan(
            m.csr, m.monitor, m.choice, num_shards=self.num_shards,
            seed=self.seed, cfg=m.rebalance_cfg,
            request_index=m.spmv_count, program=m.dist,
            amortization_horizon=self._amortization_horizon(m))
        m.rebalance_log.append(event)
        if new_dist is not None:
            # the new program's executor is built, and the old one's shapes
            # captured, on this thread; requests (which read the program
            # through the executor) switch here, and the old one is dropped
            old = m.executor
            m.executor, m.executor_build_s = self._executor(
                new_dist, [] if old is None
                else [st["shape"] for st in old.graph_stats()])
            m.dist = new_dist          # the double-buffer swing
            m.choice = new_choice
            m.monitor.attach(new_dist)
            self._persist(m)
        m.monitor.cooldown()

    def _persist(self, m: IngestedMatrix) -> None:
        """Invalidate + rewrite the tenant's artifact after a swap.

        ``save_program`` removes the old manifest before touching bytes
        and writes the new one last, so at every instant the bundle reads
        either as the *new* program or as "no artifact" — never as the
        stale pre-swap plan.
        """
        if m.bundle_dir is None or m.csr is None:
            return
        try:
            save_program(m.dist, m.bundle_dir, source=m.csr, choice=m.choice)
        except OSError:
            self.artifact_write_errors += 1

    # -- introspection -----------------------------------------------------

    def plan(self, name: str) -> SpmvPlan:
        """The plan serving ``name``."""
        return self._lookup(name).choice.plan

    def plans(self) -> Dict[str, str]:
        """name -> PlanChoice JSON for every ingested tenant."""
        return {n: m.choice.to_json() for n, m in self._matrices.items()}

    def tenants(self) -> List[str]:
        """Names of every ingested tenant (sorted)."""
        return sorted(self._matrices)

    def rebalance_log(self, name: str) -> List[RebalanceEvent]:
        """Every detector trip for ``name`` (swapped or rejected)."""
        return list(self._lookup(name).rebalance_log)

    def stats(self) -> Dict[str, dict]:
        """Lightweight per-tenant serving stats (JSON-serializable)."""
        out = {}
        for n, m in self._matrices.items():
            s = {"plan": dataclasses.asdict(m.choice.plan),
                 "bottleneck": m.choice.bottleneck,
                 "shard_kernels": list(m.dist.shard_kernels()),
                 "shard_exchanges":
                     list(m.choice.plan.resolved_shard_exchanges()),
                 "nnz": m.dist.matrix.nnz,
                 "migrations": m.dist.traffic.migrations,
                 "hotspot_share": m.dist.traffic.hotspot_share,
                 "spmv_count": m.spmv_count,
                 "plan_cache_hit": m.plan_cache_hit,
                 "warm_start": m.warm_start}
            if m.monitor is not None:
                s["rebalance"] = {
                    **m.monitor.stats(),
                    "replans": sum(e.swapped for e in m.rebalance_log),
                    "rejected": sum(not e.swapped for e in m.rebalance_log)}
            if m.batcher is not None:
                s["micro_batch"] = m.batcher.stats()
            if m.executor is not None:
                s["executor"] = {
                    "device": str(self.device),
                    "build_s": m.executor_build_s,
                    "graphs": m.executor.graph_stats()}
            out[n] = s
        return out
