"""Discrete-tick model of the Emu Chick (paper §II + §IV-D dynamics).

This is the reproduction vehicle for the paper's *Emu-side* results: the
container has no Emu hardware, so we model the machine the paper describes —

* P nodelets, each with one single-issue Gossamer Core (1 instr/cycle,
  150 MHz) and up to 64 resident threads;
* thread migration on any remote load, ~2x the cost of a local access;
* a finite egress migration queue per nodelet, serviced by the Migration
  Engine at a fixed packet rate, with per-nodelet ingress acceptance;
* thread-activity throttling when the migration queue fills (the mechanism
  behind Fig. 8's nodelet-0 collapse).

Threads execute compressed *segment traces* (nodelet, n_instructions) built
from the same walk the migration accounting uses, so the simulator and the
counter agree by construction.  Outputs: per-tick residency traces
(Figs. 8/11), total runtime -> bandwidth (Figs. 3/6/10), and per-nodelet
instruction counts (Fig. 7).

Three engines implement the same machine, tick for tick:

* ``engine="vectorized"`` (the default) keeps all thread state in flat
  ``(nthreads,)`` / ``(P,)`` arrays plus flattened segment traces.  When a
  C toolchain is available it runs the whole tick loop in a tiny compiled
  kernel (``_emu_tick.c``, built on demand by :mod:`repro_torch.core._emu_cext`);
  otherwise it runs the pure-numpy structure-of-arrays engine — no Python
  loop over threads, one short loop over nodelets per tick (the Migration
  Engine's sequential credit scan).  This is what lets the autotuner probe
  run at serving time and the Fig. 8/11 benchmarks run the full Table-I
  matrix sizes.
* ``engine="numpy"`` / ``engine="cext"`` force a specific vectorized
  backend (tests use these to pin both).
* :func:`simulate_reference` (``engine="reference"``) is the original
  per-thread Python loop, kept as the executable specification;
  ``tests/test_torch_emu.py`` pins exact equivalence (ticks,
  migrations, per-nodelet instruction counts, residency traces) across
  every engine.

The port's host copy of ``repro.core.emu`` (numpy only): the same
arithmetic, so its results equal the reference's bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .layout import VectorLayout
from .partition import Partition
from .sparse_matrix import CSRMatrix

__all__ = ["EmuConfig", "EmuResult", "build_thread_traces", "simulate",
           "simulate_reference", "run_spmv", "useful_bytes"]


def useful_bytes(csr: "CSRMatrix") -> float:
    """Bytes of useful work per SpMV: values + colIndex + x loads (8 B
    each) + rowPtr + b — the bandwidth denominator every Emu benchmark
    shares."""
    return 8.0 * (3 * csr.nnz + 2 * csr.nrows)

# Thread states
_RUNNING, _WANT, _QUEUED, _FLIGHT, _DONE = range(5)


@dataclasses.dataclass(frozen=True)
class EmuConfig:
    nodelets: int = 8
    threads_per_nodelet: int = 64
    clock_hz: float = 150e6
    tick_cycles: int = 250
    migration_queue_cap: int = 64      # egress packets per nodelet
    me_rate: int = 24                  # packets/tick a nodelet can send
    ingress_rate: int = 24             # NQM per-dest acceptance/tick
    resident_cap: int = 80             # register sets + run-queue contexts
    migration_latency_ticks: int = 1
    migration_overhead_cycles: int = 2  # ~2x a local access (paper §II-A)
    # A single-issue GC only reaches 1 instr/cycle when enough threads are
    # resident to hide DRAM latency; below this count throughput scales
    # linearly with active threads.  This is the mechanism that makes the
    # Fig. 8 throttling collapse hurt: a starved/throttled nodelet loses
    # issue bandwidth, not just queue slots.
    latency_hide_threads: int = 32
    # Cycles per memory instruction (narrow-channel DDR4 at a 150 MHz GC:
    # row activation + transfer amortize to ~8 GC cycles per 8-byte access).
    access_cycles: int = 8
    # Congestion collapse (paper §IV-D): thread contexts in a saturated
    # migration queue are staged in the nodelet's narrow-channel DRAM, so a
    # full queue steals memory bandwidth from the GC, the memory-side
    # processor *and* the NQM itself — service capacity drops with queue
    # occupancy instead of merely queueing.  ``congestion_floor`` is the
    # residual capacity at full saturation.  The paper observes exactly
    # this: "the nodelet reduces the number of threads that can be
    # executed" and fewer threads/nodelet relieve the pressure.
    congestion_floor: float = 0.3
    # Residency-trace budget: the sampling stride is derived so a run keeps
    # roughly this many (P,) samples instead of one per tick (full Table-I
    # matrices run for ~10^5-10^6 ticks; an unbounded trace is the old
    # out-of-memory failure mode).  <= 0 forces stride 1 (sample every
    # tick, the legacy behaviour).
    target_samples: int = 2048
    max_ticks: int = 2_000_000


@dataclasses.dataclass
class EmuResult:
    ticks: int
    seconds: float
    bandwidth_mbs: float
    migrations: int
    residency: np.ndarray        # (ticks_sampled, P)
    instr_per_nodelet: np.ndarray  # (P,)
    sample_every: int

    @property
    def instr_cv(self) -> float:
        """CV of per-nodelet instruction counts (the Fig. 7 balance metric).

        This was historically (mis)named ``residency_cv``; it has nothing
        to do with the residency trace.
        """
        m = self.instr_per_nodelet
        return float(m.std() / m.mean()) if m.mean() else 0.0

    @property
    def residency_cv(self) -> float:
        """CV of the *time-averaged per-nodelet thread residency*.

        Computed over the sampled residency trace: high values mean
        threads spent the run converged on few nodelets (the Fig. 8
        hot-spot signature), independent of how instructions balanced.
        """
        if self.residency.size == 0:
            return 0.0
        m = self.residency.astype(np.float64).mean(axis=0)
        return float(m.std() / m.mean()) if m.mean() else 0.0


#: Serialized carry fix-up instructions per spanned chunk boundary in the
#: seg/split home streams: each carry is a read-modify-write on the output
#: row that cannot overlap the scan (the §IV-D monster-row chain, seen by
#: the tick machine instead of only by the analytic slot model).
_KERNEL_CARRY_INSTR = 8
#: Scatter-add instructions per HYB overflow entry (indexed read-modify-
#: write on b, no scan amortization).
_KERNEL_OVF_INSTR = 4


def _home_row_weights(rows: np.ndarray, kernel: str | None) -> np.ndarray:
    """Per-row home-nodelet instruction counts for one shard's row slice.

    ``rows`` is the shard's per-row nnz vector; ``kernel`` selects the
    format's instruction stream.  ``None`` is the format-agnostic CSR walk
    (``2 + 2*nnz``) that every pre-oracle trace used — callers that do not
    pass ``shard_kernels`` get byte-identical traces.
    """
    rows = rows.astype(np.int64)
    if kernel is None:
        return 2 + 2 * rows
    if kernel == "ell":
        # Padded slab stream: every row walks the shard's widest row.
        W = int(rows.max()) if rows.size else 0
        return np.full(rows.shape, 2 + 2 * max(W, 1), dtype=np.int64)
    from ..kernels.ops import SEG_CHUNK
    if kernel == "seg":
        spans = -(-rows // SEG_CHUNK)
        carries = np.maximum(spans - 1, 0)
        return 2 + 3 * rows + _KERNEL_CARRY_INSTR * carries
    if kernel == "hyb":
        from .sparse_matrix import hyb_cap_width
        Wc = int(hyb_cap_width(rows)) if rows.size else 1
        ovf = np.maximum(rows - Wc, 0)
        return 2 + 2 * np.minimum(rows, Wc) + _KERNEL_OVF_INSTR * ovf
    if kernel == "split":
        from .plan import split_meta
        ns = split_meta(int(rows.sum()), int(rows.max()) if rows.size else 0)
        spans = -(-rows // SEG_CHUNK)
        carries = np.maximum(-(-spans // ns) - 1, 0)
        # Stage-2 combine reads ns partials back into each output row.
        return 2 + 3 * rows + _KERNEL_CARRY_INSTR * carries + ns
    if kernel == "tile":
        from .sparse_matrix import ELL_LANE, ELL_SUBLANE
        # Bitmask-tiled stream: one data load per walked cell and NO
        # per-element column-index loads (one block-col id serves a whole
        # (8, 128) tile), so a row costs half an ELL row of equal width.
        # Padding is *block-granular and block-local*: each 8-row block
        # walks ceil(widest row in the block / 128) lane tiles — a heavy
        # row widens its own block's walk, not the whole shard's (the
        # shard-wide max-width tax is ELL's, not tile's).  Dense-extent
        # approximation of the occupied-tile count; the analytic slot
        # model (plan.kernel_shard_costs) owns the scattered worst case.
        nb = rows.size
        pad = (-nb) % ELL_SUBLANE
        blk = np.pad(rows, (0, pad)).reshape(-1, ELL_SUBLANE)
        wb = np.maximum(-(-blk.max(axis=1) // ELL_LANE), 1)
        return 2 + np.repeat(wb * ELL_LANE, ELL_SUBLANE)[:nb]
    raise ValueError(f"unknown kernel format: {kernel!r}")


def build_thread_traces(csr: CSRMatrix, part: Partition, x_layout: VectorLayout,
                        threads_per_nodelet: int,
                        shard_kernels: Sequence[str] | None = None,
                        ) -> tuple[List[np.ndarray], List[np.ndarray], np.ndarray]:
    """Compressed (node, weight) segments per thread.

    Per row: the home nodelet executes 2 instrs/nnz (value+colIndex loads) +
    2 instrs (rowPtr read, b accumulate/remote-update issue); each x load is
    1 instr on the owner nodelet.  Consecutive same-node entries merge.

    ``shard_kernels`` (one format name per shard, as produced by
    ``SpmvPlan.resolved_shard_kernels()``) switches each shard's *home*
    stream to that format's instruction shape — ELL walks the padded slab
    width, seg adds the scan pass and the serialized cross-chunk carry
    fix-up, hyb caps the slab and scatter-adds the overflow, split cuts
    each carry chain by the policy split count and pays the stage-2
    combine, tile streams block-local dense tiles with no per-element
    index loads (:func:`_home_row_weights`).  The x-load stream (owner-side,
    1 instr each) is format-independent.  ``None`` keeps the historic
    format-agnostic walk, byte for byte.
    """
    P = part.num_shards
    thread_starts = part.thread_splits(csr, threads_per_nodelet)
    seg_nodes: List[np.ndarray] = []
    seg_weights: List[np.ndarray] = []
    homes = []
    owners_all = x_layout.owner_of(csr.col_index).astype(np.int32)
    rp = csr.row_ptr
    if shard_kernels is not None and len(shard_kernels) != P:
        raise ValueError(f"shard_kernels has {len(shard_kernels)} entries "
                         f"for {P} shards")
    home_w_all = np.empty(csr.nrows, dtype=np.int64)
    all_rows = np.diff(rp).astype(np.int64)
    for p in range(P):
        s0, s1 = int(part.starts[p]), int(part.starts[p + 1])
        kern = None if shard_kernels is None else shard_kernels[p]
        home_w_all[s0:s1] = _home_row_weights(all_rows[s0:s1], kern)
    for p in range(P):
        starts = thread_starts[p]
        for t in range(threads_per_nodelet):
            r0, r1 = int(starts[t]), int(starts[t + 1])
            homes.append(p)
            if r1 <= r0:
                seg_nodes.append(np.zeros(0, np.int32))
                seg_weights.append(np.zeros(0, np.int64))
                continue
            lo, hi = int(rp[r0]), int(rp[r1])
            k = hi - lo
            nrows = r1 - r0
            # Interleaved walk: home-entry at every row start, owner per nnz.
            seq = np.empty(k + nrows, dtype=np.int32)
            wts = np.empty(k + nrows, dtype=np.int64)
            home_pos = (rp[r0:r1] - lo + np.arange(nrows)).astype(np.int64)
            mask = np.zeros(k + nrows, dtype=bool)
            mask[home_pos] = True
            seq[mask] = p
            wts[mask] = home_w_all[r0:r1]      # format-shaped home stream
            seq[~mask] = owners_all[lo:hi]
            wts[~mask] = 1                      # the x load itself

            # Compress consecutive equal nodes.
            if seq.size:
                bound = np.empty(seq.size, dtype=bool)
                bound[0] = True
                bound[1:] = seq[1:] != seq[:-1]
                idx = np.flatnonzero(bound)
                nodes = seq[idx]
                csum = np.concatenate([[0], np.cumsum(wts)])
                ends = np.concatenate([idx[1:], [seq.size]])
                weights = csum[ends] - csum[idx]
            else:
                nodes = np.zeros(0, np.int32)
                weights = np.zeros(0, np.int64)
            seg_nodes.append(nodes)
            seg_weights.append(weights)
    return seg_nodes, seg_weights, np.asarray(homes, dtype=np.int32)


def _sample_stride(total_cycles: int, cfg: EmuConfig) -> int:
    """Residency-sampling stride shared by both engines.

    The true tick count is unknowable up front (congestion inflates it),
    so the stride targets ``cfg.target_samples`` rows against the
    *congestion-free lower bound* on ticks — total trace cycles spread
    over P nodelets at full issue rate.  Congestion then only inflates the
    stored trace by the (bounded) slowdown factor, instead of growing one
    row per tick up to ``max_ticks``.
    """
    if cfg.target_samples <= 0:
        return 1
    est_ticks = max(total_cycles // (cfg.nodelets * cfg.tick_cycles), 1)
    return max(1, est_ticks // cfg.target_samples)


def simulate(seg_nodes: Sequence[np.ndarray], seg_weights: Sequence[np.ndarray],
             homes: np.ndarray, cfg: EmuConfig, useful_bytes: float, *,
             engine: str = "vectorized") -> EmuResult:
    """Run the tick machine over compressed thread traces.

    ``engine="vectorized"`` (default) runs the structure-of-arrays engine,
    through the compiled tick kernel when a C toolchain is available and
    as pure numpy otherwise; ``engine="cext"`` / ``engine="numpy"`` force
    one backend (``cext`` raises if the kernel cannot be built);
    ``engine="reference"`` runs the legacy per-thread Python loop.  All
    engines produce identical results (see
    ``tests/test_torch_emu.py``); the reference engine is O(threads)
    Python work per tick and exists as the executable specification.
    """
    if engine in ("vectorized", "cext"):
        res = _simulate_cext(seg_nodes, seg_weights, homes, cfg,
                             useful_bytes)
        if res is not None:
            return res
        if engine == "cext":
            raise RuntimeError("the compiled Emu tick kernel is unavailable "
                               "(no C toolchain, or REPRO_EMU_DISABLE_CEXT "
                               "is set)")
        return _simulate_numpy(seg_nodes, seg_weights, homes, cfg,
                               useful_bytes)
    if engine == "numpy":
        return _simulate_numpy(seg_nodes, seg_weights, homes, cfg,
                               useful_bytes)
    if engine == "reference":
        return simulate_reference(seg_nodes, seg_weights, homes, cfg,
                                  useful_bytes)
    raise ValueError(f"unknown engine: {engine!r}; expected 'vectorized', "
                     f"'cext', 'numpy' or 'reference'")


def _flatten_state(seg_nodes: Sequence[np.ndarray],
                   seg_weights: Sequence[np.ndarray],
                   homes: np.ndarray, cfg: EmuConfig) -> dict:
    """Shared structure-of-arrays initial state for the fast engines.

    Flattens the per-thread segment lists into ``(total_segments,)`` node /
    cost arrays addressed by an absolute per-thread pointer, and applies
    the reference engine's initialization (empty threads are DONE, a
    remote first segment starts in WANT).
    """
    nthreads = len(seg_nodes)
    nseg = np.fromiter((s.size for s in seg_nodes), dtype=np.int64,
                       count=nthreads)
    seg_off = np.concatenate([[0], np.cumsum(nseg)]).astype(np.int64)
    if seg_off[-1]:
        flat_nodes = np.ascontiguousarray(
            np.concatenate(seg_nodes).astype(np.int64, copy=False))
        flat_cost = np.ascontiguousarray(
            np.concatenate(seg_weights).astype(np.int64) * cfg.access_cycles)
    else:
        flat_nodes = np.zeros(1, np.int64)
        flat_cost = np.zeros(1, np.int64)

    loc = np.asarray(homes, dtype=np.int64).copy()
    state = np.full(nthreads, _RUNNING, dtype=np.int8)
    ptr = seg_off[:-1].copy()              # absolute index into flat arrays
    seg_end = np.ascontiguousarray(seg_off[1:])
    rem = np.zeros(nthreads, dtype=np.int64)
    dest = np.full(nthreads, -1, dtype=np.int64)

    empty = nseg == 0
    state[empty] = _DONE
    ne = np.flatnonzero(~empty)
    if ne.size:
        rem[ne] = flat_cost[ptr[ne]]
        first = flat_nodes[ptr[ne]]
        away = first != loc[ne]
        # First segment is remote (possible under nnz distribution).
        state[ne[away]] = _WANT
        dest[ne[away]] = first[away]

    total_cycles = int(flat_cost.sum()) if seg_off[-1] else 0
    return dict(nthreads=nthreads, flat_nodes=flat_nodes,
                flat_cost=flat_cost, seg_end=seg_end, loc=loc, state=state,
                ptr=ptr, rem=rem, dest=dest, n_done=int(empty.sum()),
                sample_every=_sample_stride(total_cycles, cfg))


def _simulate_cext(seg_nodes: Sequence[np.ndarray],
                   seg_weights: Sequence[np.ndarray],
                   homes: np.ndarray, cfg: EmuConfig,
                   useful_bytes: float) -> EmuResult | None:
    """Run the compiled tick kernel; None when it cannot be built/loaded.

    The kernel advances the whole tick loop in C over the same flat state
    arrays the numpy engine uses; when the residency sample buffer fills
    (congestion can inflate the tick count well past the stride's
    estimate) it returns with all state written back, the buffer is grown,
    and the kernel resumes at the same tick.
    """
    from . import _emu_cext
    kernel = _emu_cext.load_kernel()
    if kernel is None:
        return None
    st = _flatten_state(seg_nodes, seg_weights, homes, cfg)
    nthreads = st["nthreads"]
    P = cfg.nodelets
    sample_every = st["sample_every"]
    arrive = np.full(nthreads, -1, dtype=np.int64)
    egress = np.zeros((P, cfg.migration_queue_cap), dtype=np.int64)
    qlen = np.zeros(P, dtype=np.int64)
    instr = np.zeros(P, dtype=np.int64)
    scratch_n = max(nthreads, 1)
    run_buf = np.empty(scratch_n, dtype=np.int64)
    run_cnt = np.empty(P, dtype=np.int64)
    run_off = np.empty(P + 1, dtype=np.int64)
    cur = np.empty(scratch_n, dtype=np.int64)
    alive = np.empty(scratch_n, dtype=np.int64)
    residents = np.empty(P, dtype=np.int64)
    credits = np.empty(P, dtype=np.int64)
    cong = np.empty(P, dtype=np.float64)
    res_cap = max(2 * cfg.target_samples, 1024)
    res_buf = np.zeros((res_cap, P), dtype=np.int32)
    res_len = np.zeros(1, dtype=np.int64)
    regs = np.zeros(4, dtype=np.int64)     # tick, rr, migrations, n_done
    regs[3] = st["n_done"]
    while True:
        paused = kernel(
            nthreads, P, cfg.threads_per_nodelet, cfg.tick_cycles,
            cfg.migration_queue_cap, cfg.me_rate, cfg.ingress_rate,
            cfg.resident_cap, cfg.migration_latency_ticks,
            cfg.migration_overhead_cycles, cfg.latency_hide_threads,
            cfg.congestion_floor, cfg.max_ticks, sample_every,
            st["flat_nodes"], st["flat_cost"], st["seg_end"],
            st["loc"], st["state"], st["ptr"], st["rem"], st["dest"],
            arrive, egress.reshape(-1), qlen, instr,
            run_buf, run_cnt, run_off, cur, alive, residents, credits,
            cong, res_buf.reshape(-1), res_cap, res_len,
            regs[0:1], regs[1:2], regs[2:3], regs[3:4])
        if not paused:
            break
        grown = np.zeros((2 * res_cap, P), dtype=np.int32)
        grown[:res_cap] = res_buf
        res_buf, res_cap = grown, 2 * res_cap
    tick = int(regs[0])
    seconds = tick * cfg.tick_cycles / cfg.clock_hz
    bw = useful_bytes / seconds / 1e6 if seconds > 0 else 0.0
    return EmuResult(ticks=tick, seconds=seconds, bandwidth_mbs=bw,
                     migrations=int(regs[2]),
                     residency=res_buf[:int(res_len[0])].copy(),
                     instr_per_nodelet=instr, sample_every=sample_every)


def _simulate_numpy(seg_nodes: Sequence[np.ndarray],
                    seg_weights: Sequence[np.ndarray],
                    homes: np.ndarray, cfg: EmuConfig,
                    useful_bytes: float) -> EmuResult:
    """Pure-numpy structure-of-arrays tick engine.

    All per-thread state lives in flat ``(nthreads,)`` arrays; the segment
    traces are flattened to ``(total_segments,)`` arrays indexed by an
    absolute per-thread pointer.  Each tick runs four phases as array ops:

    1. *Execute*: per-nodelet selection (throttle cap + round-robin
       rotation) scatters the selected threads into a dense
       ``(P, threads_per_nodelet)`` slot matrix in rotation order; the
       fair-share budget split then runs as short vectorized passes over
       that matrix across **all** nodelets at once (a pass is one round
       of the reference engine's inner ``while budget`` loop — the
       rotation-order rank is the row position, so the "first *budget*
       threads get one cycle" tail case is a single masked compare).
    2. *Enqueue*: WANT threads enter their nodelet's egress queue in
       thread-id order while slots remain (queues are plain per-nodelet
       id arrays in FIFO order).
    3. *Migration Engine*: queues are serviced in nodelet order against a
       shared per-destination credit vector — the one Python loop over
       nodelets per tick (the credit handoff is inherently sequential).
       Within a queue, the reference's FIFO-with-skip scan reduces to:
       the first ``credits[d]`` entries per destination are candidates,
       and the first ``rate_p`` candidates in queue order are sent.
    4. *Arrivals* pop the in-flight FIFO (everything sent at tick T lands
       at T + latency, so the FIFO is sorted by construction).
    """
    st = _flatten_state(seg_nodes, seg_weights, homes, cfg)
    nthreads = st["nthreads"]
    P = cfg.nodelets
    qcap = cfg.migration_queue_cap
    tpn = cfg.threads_per_nodelet
    W = max(tpn, 2)                        # slot width (throttle floor is 2)
    flat_nodes, flat_cost = st["flat_nodes"], st["flat_cost"]
    loc, state = st["loc"], st["state"]
    ptr, seg_end = st["ptr"], st["seg_end"]
    rem, dest = st["rem"], st["dest"]

    instr = np.zeros(P, dtype=np.int64)
    migrations = 0
    res_trace: list[np.ndarray] = []
    sample_every = st["sample_every"]
    rr = 0  # round-robin offset for fairness
    n_done = st["n_done"]

    # Egress queues: per-nodelet id arrays in FIFO order, occupancy mirror.
    EMPTY_Q = np.empty(0, dtype=np.int64)
    queues: list[np.ndarray] = [EMPTY_Q] * P
    occ = np.zeros(P, dtype=np.int64)
    total_q = 0
    # In-flight FIFO: (landing_tick, [id arrays]) appended once per tick.
    in_flight: list[tuple[int, list[np.ndarray]]] = []

    AR_P = np.arange(P, dtype=np.int64)
    AR_PC = AR_P[:, None]
    ARQ = np.arange(qcap, dtype=np.int64)
    CONG_IDLE = np.ones(P)
    CAP_IDLE = np.full(P, W, dtype=np.int64)    # max(2, tpn) when idle
    # Dense execution slots: (P, W) thread id / active / remaining-cycles.
    slot_id = np.empty((P, W), dtype=np.int64)
    slot_idf = slot_id.ravel()
    mig_cycles = cfg.migration_overhead_cycles
    latency = cfg.migration_latency_ticks

    tick = 0
    while tick < cfg.max_ticks and n_done < nthreads:
        # Congestion factor per nodelet from egress-queue occupancy.
        if total_q:
            t_frac = occ / qcap
            cong = 1.0 - (1.0 - cfg.congestion_floor) * t_frac
            # Throttle thread activity as the migration queue fills
            # (paper §IV-D: ~32 of 64 threads active on the hot nodelet).
            cap = np.maximum(2, (tpn * (1.0 - t_frac)).astype(np.int64))
        else:
            cong = CONG_IDLE
            cap = CAP_IDLE
        # --- 1. execute on each nodelet ---------------------------------
        run_mask = state == _RUNNING
        if run_mask.any():
            # Rank of each running thread within its nodelet (ascending
            # id): cumulative count along a (P, nthreads) membership map.
            member = (loc == AR_PC) & run_mask
            csum = member.cumsum(axis=1, dtype=np.int64)
            counts = csum[:, -1]
            rank = csum.reshape(-1).take(loc * nthreads +
                                         np.arange(nthreads)) - 1
            rot = (rank - rr) % np.maximum(counts, 1).take(loc)
            sel = run_mask & (rot < cap.take(loc))
            sel_ids = np.flatnonzero(sel)
            pos = loc.take(sel_ids) * W + rot.take(sel_ids)
            slot_idf.fill(-1)
            slot_idf[pos] = sel_ids
            active = slot_id >= 0
            activef = active.ravel()
            rem_b = np.zeros((P, W), dtype=np.int64)
            rem_bf = rem_b.ravel()
            rem_bf[pos] = rem.take(sel_ids)
            nsel = np.minimum(counts, cap)
            # Issue bandwidth degrades when too few threads hide latency,
            # and when the migration queue steals DRAM bandwidth.
            eff = np.minimum(1.0, nsel / cfg.latency_hide_threads) * cong
            budget = (cfg.tick_cycles * eff).astype(np.int64)
            # Fair-share passes: every nodelet's threads split its budget
            # until budgets or work run out (one pass == one round of the
            # reference engine's inner loop, all nodelets at once).
            while True:
                n_act = active.sum(axis=1)
                if not ((budget > 0) & (n_act > 0)).any():
                    break
                share = np.maximum(budget // np.maximum(n_act, 1), 1)
                take = np.minimum(share[:, None], rem_b)
                # Budget below the thread count: share is 1 and only the
                # first ``budget`` threads in rotation order get a cycle.
                lowb = budget < n_act
                if lowb.any():
                    rank_b = active.cumsum(axis=1, dtype=np.int64)
                    low_take = (rank_b <= budget[:, None]) & active
                    take = np.where(lowb[:, None], low_take, take)
                spent = take.sum(axis=1)
                instr += spent
                budget -= spent
                rem_b -= take
                fin = active & (rem_b == 0)
                if fin.any():
                    # Segment finished: advance to the next one.
                    posf = np.flatnonzero(fin.ravel())
                    ft = slot_idf.take(posf)
                    nptr = ptr.take(ft) + 1
                    ptr[ft] = nptr
                    over = nptr >= seg_end.take(ft)
                    done_ids = ft[over]
                    if done_ids.size:
                        state[done_ids] = _DONE
                        n_done += done_ids.size
                        activef[posf[over]] = False
                    cont = ft[~over]
                    if cont.size:
                        cpos = posf[~over]
                        ncost = flat_cost.take(nptr[~over])
                        nxt = flat_nodes.take(nptr[~over])
                        away = nxt != loc.take(cont)
                        aw = cont[away]
                        if aw.size:
                            state[aw] = _WANT
                            dest[aw] = nxt[away]
                            rem[aw] = ncost[away]
                            activef[cpos[away]] = False
                        rem_bf[cpos] = np.where(away, 0, ncost)
            # Write the partial segment progress back to the master state.
            aidx = np.flatnonzero(activef)
            if aidx.size:
                rem[slot_idf.take(aidx)] = rem_bf.take(aidx)
        rr += 1

        # --- 2. migration requests -> egress queues ----------------------
        want_ids = np.flatnonzero(state == _WANT)
        if want_ids.size:
            wloc = loc.take(want_ids)
            if int(wloc.max()) == int(wloc.min()):
                groups = [(int(wloc[0]), want_ids)]
            else:
                worder = np.argsort(wloc, kind="stable")
                ws = want_ids.take(worder)
                wcnt = np.bincount(wloc, minlength=P)
                woff = np.concatenate([[0], np.cumsum(wcnt)])
                groups = [(p, ws[woff[p]: woff[p + 1]])
                          for p in np.flatnonzero(wcnt)]
            for p, grp in groups:
                room = qcap - int(occ[p])
                if room <= 0:
                    continue
                acc = grp[:room]
                queues[p] = np.concatenate([queues[p], acc]) \
                    if queues[p].size else acc
                occ[p] += acc.size
                total_q += acc.size
                state[acc] = _QUEUED
        # --- 3. Migration Engine service with destination backpressure ---
        # Egress service degrades with the source's congestion; a packet is
        # accepted only while the destination has run-queue slots left, so a
        # hot nodelet's overflow backs up into every parent's egress queue
        # (the paper's Fig. 8 pile-up on the non-hot nodelets).
        if total_q:
            on_node = (state != _FLIGHT) & (state != _DONE)
            residents = np.bincount(loc[on_node], minlength=P)
            # Floor of 1 credit: a full nodelet still trickle-accepts, which
            # is both what the hardware does and the anti-deadlock guarantee.
            credits = np.maximum(
                np.minimum(cfg.ingress_rate, cfg.resident_cap - residents), 1)
            sent_this_tick: list[np.ndarray] = []
            for p in range(P):
                k = int(occ[p])
                if k == 0:
                    continue
                seg = queues[p]                        # FIFO order
                d = dest.take(seg)
                rate_p = max(int(cfg.me_rate * cong[p]), 1)
                if k <= rate_p and k <= int(credits.min()):
                    # Uncontended: every packet is sent.
                    sent = seg
                    queues[p] = EMPTY_Q
                    credits -= np.bincount(d, minlength=P)
                else:
                    # FIFO-with-skip == first credits[d] entries per dest
                    # are candidates; first rate_p candidates are sent.
                    oh = d[:, None] == AR_P
                    drank = oh.cumsum(axis=0).reshape(-1).take(
                        ARQ[:k] * P + d) - 1
                    cand = drank < credits.take(d)
                    sent_m = cand & (np.cumsum(cand) <= rate_p)
                    nsent = int(sent_m.sum())
                    if nsent == 0:
                        continue
                    if nsent == k:
                        sent = seg
                        queues[p] = EMPTY_Q
                    else:
                        sent = seg[sent_m]
                        queues[p] = seg[~sent_m]
                    credits -= np.bincount(d[sent_m], minlength=P)
                state[sent] = _FLIGHT
                occ[p] -= sent.size
                total_q -= sent.size
                migrations += sent.size
                instr[p] += sent.size * mig_cycles
                sent_this_tick.append(sent)
            if sent_this_tick:
                in_flight.append((tick + latency, sent_this_tick))
        # --- 4. arrivals --------------------------------------------------
        while in_flight and in_flight[0][0] <= tick:
            _, chunks = in_flight.pop(0)
            land = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            loc[land] = dest.take(land)
            state[land] = _RUNNING

        # --- residency sample (threads on nodelet: running/waiting/queued) -
        if tick % sample_every == 0:
            live = (state != _FLIGHT) & (state != _DONE)
            res_trace.append(
                np.bincount(loc[live], minlength=P).astype(np.int32))
        tick += 1

    seconds = tick * cfg.tick_cycles / cfg.clock_hz
    bw = useful_bytes / seconds / 1e6 if seconds > 0 else 0.0
    return EmuResult(ticks=tick, seconds=seconds, bandwidth_mbs=bw,
                     migrations=migrations,
                     residency=np.asarray(res_trace), instr_per_nodelet=instr,
                     sample_every=sample_every)


def simulate_reference(seg_nodes: Sequence[np.ndarray],
                       seg_weights: Sequence[np.ndarray],
                       homes: np.ndarray, cfg: EmuConfig,
                       useful_bytes: float) -> EmuResult:
    """Per-thread Python-loop engine: the executable specification.

    O(threads) Python work per tick — orders of magnitude slower than the
    vectorized engine, but trivially auditable against the paper's §II /
    §IV-D machine description.  Kept so the equivalence suite can pin the
    vectorized engine tick-for-tick.
    """
    nthreads = len(seg_nodes)
    P = cfg.nodelets
    loc = homes.copy()
    state = np.full(nthreads, _RUNNING, dtype=np.int8)
    ptr = np.zeros(nthreads, dtype=np.int64)
    rem = np.zeros(nthreads, dtype=np.int64)
    dest = np.full(nthreads, -1, dtype=np.int32)
    arrive = np.full(nthreads, -1, dtype=np.int64)
    nseg = np.array([s.size for s in seg_nodes], dtype=np.int64)
    for t in range(nthreads):
        if nseg[t] == 0:
            state[t] = _DONE
        else:
            rem[t] = seg_weights[t][0] * cfg.access_cycles
            if seg_nodes[t][0] != homes[t]:
                # First segment is remote (possible under nnz distribution).
                state[t] = _WANT
                dest[t] = seg_nodes[t][0]
            else:
                loc[t] = seg_nodes[t][0]

    egress: list[list[int]] = [[] for _ in range(P)]
    instr = np.zeros(P, dtype=np.int64)
    migrations = 0
    res_trace = []
    total_cycles = sum(int(w.sum()) for w in seg_weights) * cfg.access_cycles
    sample_every = _sample_stride(total_cycles, cfg)
    rr = 0  # round-robin offset for fairness

    def advance(t: int) -> None:
        """Thread t finished its segment; set up the next one."""
        nonlocal migrations
        ptr[t] += 1
        if ptr[t] >= nseg[t]:
            state[t] = _DONE
            return
        rem[t] = seg_weights[t][ptr[t]] * cfg.access_cycles
        nxt = seg_nodes[t][ptr[t]]
        if nxt != loc[t]:
            state[t] = _WANT
            dest[t] = nxt
        # else: stays RUNNING on the same nodelet

    tick = 0
    while tick < cfg.max_ticks:
        if not (state != _DONE).any():
            break
        # Congestion factor per nodelet from egress-queue occupancy.
        cong = np.array([1.0 - (1.0 - cfg.congestion_floor) *
                         (len(egress[p]) / cfg.migration_queue_cap)
                         for p in range(P)])
        # --- 1. execute on each nodelet ---------------------------------
        for p in range(P):
            running = np.flatnonzero((state == _RUNNING) & (loc == p))
            if running.size == 0:
                continue
            occ = len(egress[p])
            # Throttle thread activity as the migration queue fills
            # (paper §IV-D: ~32 of 64 threads active on the hot nodelet).
            cap = max(2, int(cfg.threads_per_nodelet *
                             (1.0 - occ / cfg.migration_queue_cap)))
            running = np.roll(running, -rr)[:cap]
            # Issue bandwidth degrades when too few threads hide latency,
            # and when the migration queue steals DRAM bandwidth.
            eff = min(1.0, running.size / cfg.latency_hide_threads) * cong[p]
            budget = int(cfg.tick_cycles * eff)
            # Fair-share pass: threads cycle until budget or work runs out.
            while budget > 0 and running.size:
                share = max(budget // running.size, 1)
                alive = []
                for t in running:
                    if budget <= 0:
                        break
                    take = min(share, int(rem[t]), budget)
                    rem[t] -= take
                    budget -= take
                    instr[p] += take
                    if rem[t] == 0:
                        advance(int(t))
                    if state[t] == _RUNNING and loc[t] == p:
                        alive.append(t)
                running = np.asarray(alive, dtype=np.int64)
        rr += 1

        # --- 2. migration requests -> egress queues ----------------------
        want = np.flatnonzero(state == _WANT)
        for t in want:
            p = int(loc[t])
            if len(egress[p]) < cfg.migration_queue_cap:
                egress[p].append(int(t))
                state[t] = _QUEUED
        # --- 3. Migration Engine service with destination backpressure ---
        # Egress service degrades with the source's congestion; a packet is
        # accepted only while the destination has run-queue slots left, so a
        # hot nodelet's overflow backs up into every parent's egress queue
        # (the paper's Fig. 8 pile-up on the non-hot nodelets).
        residents = np.zeros(P, dtype=np.int64)
        on_node = (state != _FLIGHT) & (state != _DONE)
        np.add.at(residents, loc[on_node], 1)
        # Floor of 1 credit: a full nodelet still trickle-accepts, which is
        # both what the hardware does and the anti-deadlock guarantee.
        credits = np.maximum(
            np.minimum(cfg.ingress_rate, cfg.resident_cap - residents), 1)
        for p in range(P):
            q = egress[p]
            rate_p = max(int(cfg.me_rate * cong[p]), 1)
            sent, kept = 0, []
            for t in q:
                d = int(dest[t])
                if sent < rate_p and credits[d] > 0:
                    credits[d] -= 1
                    sent += 1
                    state[t] = _FLIGHT
                    arrive[t] = tick + cfg.migration_latency_ticks
                    migrations += 1
                    instr[p] += cfg.migration_overhead_cycles
                else:
                    kept.append(t)
            egress[p] = kept
        # --- 4. arrivals --------------------------------------------------
        landing = np.flatnonzero((state == _FLIGHT) & (arrive <= tick))
        for t in landing:
            loc[t] = dest[t]
            dest[t] = -1
            state[t] = _RUNNING

        # --- residency sample (threads on nodelet: running/waiting/queued) -
        if tick % sample_every == 0:
            counts = np.zeros(P, dtype=np.int32)
            on_node = state != _FLIGHT
            live = on_node & (state != _DONE)
            np.add.at(counts, loc[live], 1)
            res_trace.append(counts)
        tick += 1

    seconds = tick * cfg.tick_cycles / cfg.clock_hz
    bw = useful_bytes / seconds / 1e6 if seconds > 0 else 0.0
    return EmuResult(ticks=tick, seconds=seconds, bandwidth_mbs=bw,
                     migrations=migrations,
                     residency=np.asarray(res_trace), instr_per_nodelet=instr,
                     sample_every=sample_every)


def run_spmv(csr: CSRMatrix, part: Partition, x_layout: VectorLayout,
             cfg: EmuConfig | None = None, *,
             engine: str = "vectorized",
             shard_kernels: Sequence[str] | None = None) -> EmuResult:
    """End-to-end: build traces for (matrix, partition, layout) and simulate.

    ``shard_kernels`` forwards to :func:`build_thread_traces` so a probe
    can replay the *format-shaped* instruction streams of a lowered
    per-shard program instead of the format-agnostic CSR walk.
    """
    cfg = cfg or EmuConfig(nodelets=part.num_shards)
    nodes, weights, homes = build_thread_traces(csr, part, x_layout,
                                                cfg.threads_per_nodelet,
                                                shard_kernels=shard_kernels)
    return simulate(nodes, weights, homes, cfg, useful_bytes(csr),
                    engine=engine)
