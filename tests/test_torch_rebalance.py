"""The port's online rebalancer: every test of ``tests/test_rebalance.py``
on ``repro_torch`` (engines on the reference's float64 ``backend="numpy"``,
same assertions and tolerances; the drifting stream also on the device
backend on the CPU, within |A|·|x|-scaled 2e-4 of ``csr_matvec``, with
the reference's events and a fresh executor for the swapped program),
plus one parity test: the same drifting stream through the reference's
and the port's engines gives equal ``RebalanceEvent.to_dict()`` lists,
equal swapped plans and bitwise-equal answers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.serve.router as r_router
import repro.serve.rebalance as r_rebalance
import repro.data.matrices as r_mat

from repro_torch.core.layout import make_layout
from repro_torch.core.migration import count_migrations, migration_arrivals, \
    remote_access_matrix, shard_load_map
from repro_torch.core.partition import make_partition, partition_nonzeros
from repro_torch.core.sparse_matrix import csr_matvec, csr_row_nnz
from repro_torch.data.matrices import make_matrix
from repro_torch.kernels import ops as kops
from repro_torch.serve import SparseMatrixEngine
from repro_torch.serve.rebalance import LoadMonitor, RebalanceConfig

from test_torch_host import _to_port

torch.set_num_threads(1)

CFG = RebalanceConfig(window=32, patience=2, cooldown=2, probe=2)
TOL = 2e-4


def _engine(A, cfg=CFG, backend="numpy"):
    eng = SparseMatrixEngine(num_shards=4, rebalance=cfg, backend=backend,
                             device="cpu")
    eng.ingest("a", A)
    return eng


def _scaled_err(A, x, y) -> float:
    absA = dataclasses.replace(A, values=np.abs(A.values))
    return float((np.abs(y - csr_matvec(A, x))
                  / (1.0 + csr_matvec(absA, np.abs(x)))).max())


def _hot_cols(eng, name="a"):
    """Columns (caller order) the active program placed on shard 0."""
    d = eng._matrices[name].dist
    order = np.arange(d.matrix.ncols) if d.perm is None else d.perm
    return np.flatnonzero(d.x_layout.owner_of(order) == 0)


def _request(rng, N, k, cols=None):
    x = np.zeros(N)
    idx = rng.integers(0, N, k) if cols is None else rng.choice(cols, size=k)
    x[idx] = rng.standard_normal(k)
    return x


def _seg_oracle(A, x):
    """Full-matrix seg_spmv_ref oracle in the caller's index order."""
    seg = kops.seg_from_csr(A)
    return np.asarray(kops.seg_spmv_ref(seg.vals, seg.cols, seg.rows,
                                        np.asarray(x, np.float32),
                                        num_rows=A.nrows))


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_drifting_stream_trips_and_swaps_consistently(backend):
    """(a) hot stream trips the detector; (b) y = A @ x stays consistent
    with the seg_spmv_ref oracle through the swap (on the device backend:
    the float32 executor, held to the scaled tolerance, and a fresh
    executor for the swapped-in program)."""
    A = make_matrix("cop20k_A", scale=0.005)
    N = A.ncols
    eng = _engine(A, backend=backend)
    m = eng._matrices["a"]
    first = m.executor
    hot = _hot_cols(eng)
    rng = np.random.default_rng(0)
    k = max(N // 20, 8)

    for _ in range(2 * CFG.window):                      # warm-up, uniform
        eng.spmv("a", _request(rng, N, k))
    assert not m.rebalance_log                           # no false trip

    swapped_at = None
    for i in range(10 * CFG.window):
        x = _request(rng, N, k, cols=hot)
        y = eng.spmv("a", x)
        # consistency with the kernel-path oracle before/through/after swap
        np.testing.assert_allclose(y, _seg_oracle(A, x), atol=1e-3,
                                   rtol=1e-4)
        if backend == "numpy":
            np.testing.assert_allclose(y, csr_matvec(A, x), atol=1e-4,
                                       rtol=1e-5)
        else:
            assert _scaled_err(A, x, y) <= TOL
        if swapped_at is None and any(e.swapped for e in m.rebalance_log):
            swapped_at = i
    assert m.monitor.trips >= 1, "hot-spot stream never tripped the detector"
    assert swapped_at is not None, "detector tripped but nothing swapped"
    swap = next(e for e in m.rebalance_log if e.swapped)
    # the swap was load-motivated and helped: weighted CV dropped a lot
    assert swap.load_cv_before > 2 * swap.load_cv_after
    # oracle gate held: the modeled seconds improved
    assert swap.probe_new_seconds < swap.probe_old_seconds
    # the served plan is the swapped-in one
    assert eng.plan("a") == swap.new_plan
    # repeated identical requests are bitwise stable on the new program
    x = _request(rng, N, k, cols=hot)
    assert np.array_equal(eng.spmv("a", x), eng.spmv("a", x))
    if backend == "device":
        # the swapped-in program answers through its own executor, whose
        # operands are its own
        assert m.executor is not first and m.executor.program is m.dist
        assert not any(t is u for t in m.executor.operands.values()
                       for u in first.operands.values())
    else:
        assert m.executor is None


def test_stable_stream_never_replans():
    """(c) hysteresis: a uniform stream closes many windows, zero trips."""
    A = make_matrix("cop20k_A", scale=0.005)
    N = A.ncols
    eng = _engine(A)
    m = eng._matrices["a"]
    rng = np.random.default_rng(1)
    k = max(N // 20, 8)
    for _ in range(8 * CFG.window):
        eng.spmv("a", _request(rng, N, k))
    assert m.monitor.windows_closed >= 8
    assert m.monitor.trips == 0
    assert not m.rebalance_log
    assert eng.stats()["a"]["rebalance"]["replans"] == 0


def test_single_burst_does_not_trip():
    """patience=2 means one hot window alone never triggers a re-plan."""
    A = make_matrix("cop20k_A", scale=0.005)
    N = A.ncols
    eng = _engine(A)
    m = eng._matrices["a"]
    hot = _hot_cols(eng)
    rng = np.random.default_rng(2)
    k = max(N // 20, 8)
    for _ in range(CFG.window):                 # exactly one hot window
        eng.spmv("a", _request(rng, N, k, cols=hot))
    for _ in range(4 * CFG.window):             # back to uniform
        eng.spmv("a", _request(rng, N, k))
    assert m.monitor.trips == 0
    assert not m.rebalance_log


def test_monitor_baseline_matches_static_counts():
    """Uniform activity through the load map == count_migrations' counts."""
    A = make_matrix("ford1", scale=0.05)
    part = make_partition(A, 4, "nonzero")
    xl = make_layout("block", A.ncols, 4)
    bl = make_layout("block", A.nrows, 4)
    lm, base = shard_load_map(A, part, xl, bl)
    static = count_migrations(A, part, xl, bl).mem_instr_per_nodelet
    np.testing.assert_allclose(lm @ np.ones(A.ncols) + base,
                               static.astype(np.float64))


def test_weighted_accounting_reduces_to_unweighted():
    """col_weight=1 reproduces the exact integer counts."""
    A = make_matrix("cop20k_A", scale=0.005)
    part = make_partition(A, 4, "row")
    xl = make_layout("block", A.ncols, 4)
    ones = np.ones(A.ncols)
    np.testing.assert_allclose(
        migration_arrivals(A, part, xl, col_weight=ones),
        migration_arrivals(A, part, xl).astype(np.float64))
    np.testing.assert_allclose(
        remote_access_matrix(A, part, xl, col_weight=ones),
        remote_access_matrix(A, part, xl).astype(np.float64))


def test_weighted_nonzero_partition_balances_weighted_work():
    """Traffic-weighted nnz split equalizes weighted (not raw) nnz."""
    A = make_matrix("webbase-1M", scale=0.001)
    w_col = np.ones(A.ncols)
    w_col[: A.ncols // 8] = 50.0            # hot leading columns
    nnz_w = w_col[A.col_index]
    part = partition_nonzeros(A, 4, nnz_weight=nnz_w)
    rows = np.repeat(np.arange(A.nrows), csr_row_nnz(A))
    per_shard = np.zeros(4)
    np.add.at(per_shard, part.owner_of_rows(A.nrows)[rows], nnz_w)
    cv_weighted = per_shard.std() / per_shard.mean()
    # the unweighted split leaves the weighted work skewed
    part0 = partition_nonzeros(A, 4)
    per0 = np.zeros(4)
    np.add.at(per0, part0.owner_of_rows(A.nrows)[rows], nnz_w)
    cv_unweighted = per0.std() / per0.mean()
    assert cv_weighted < 0.5 * cv_unweighted
    # and it still covers every row exactly once
    assert part.starts[0] == 0 and part.starts[-1] == A.nrows
    assert (np.diff(part.starts) >= 0).all()


def test_rejected_replan_keeps_serving_old_plan():
    """min_gain=1.0 rejects every candidate; serving must not degrade."""
    A = make_matrix("cop20k_A", scale=0.005)
    N = A.ncols
    cfg = RebalanceConfig(window=32, patience=2, cooldown=2, probe=2,
                          min_gain=1.0)
    eng = _engine(A, cfg)
    m = eng._matrices["a"]
    plan0 = eng.plan("a")
    hot = _hot_cols(eng)
    rng = np.random.default_rng(3)
    k = max(N // 20, 8)
    for _ in range(6 * cfg.window):
        x = _request(rng, N, k, cols=hot)
        np.testing.assert_allclose(eng.spmv("a", x), csr_matvec(A, x),
                                   atol=1e-4, rtol=1e-5)
    assert eng.plan("a") == plan0
    assert m.rebalance_log and all(not e.swapped for e in m.rebalance_log)


def test_async_replan_swaps_off_the_request_path():
    """async_replan=True: the triggering request returns immediately, the
    worker swaps in the validated plan, and serving stays correct while
    (and after) the re-plan runs on the old program."""
    A = make_matrix("cop20k_A", scale=0.005)
    N = A.ncols
    cfg = RebalanceConfig(window=32, patience=2, cooldown=2, probe=2,
                          async_replan=True)
    eng = _engine(A, cfg)
    m = eng._matrices["a"]
    hot = _hot_cols(eng)
    rng = np.random.default_rng(4)
    k = max(N // 20, 8)
    for _ in range(2 * cfg.window):
        eng.spmv("a", _request(rng, N, k))
    for _ in range(6 * cfg.window):
        x = _request(rng, N, k, cols=hot)
        np.testing.assert_allclose(eng.spmv("a", x), csr_matvec(A, x),
                                   atol=1e-4, rtol=1e-5)
        if m.replan_thread is not None:
            break
    assert m.replan_thread is not None, "detector never handed off a re-plan"
    m.replan_thread.join(timeout=120)
    assert not m.replan_thread.is_alive()
    assert any(e.swapped for e in m.rebalance_log)
    x = _request(rng, N, k, cols=hot)
    np.testing.assert_allclose(eng.spmv("a", x), csr_matvec(A, x),
                               atol=1e-4, rtol=1e-5)


def test_partial_replan_swaps_only_hot_shards():
    """A shard-0-concentrated workload re-kernels *only* the hot shard:
    the partial tier relowers that stage, shares every other stage object
    with the incumbent program, and the result still matches the oracle."""
    from repro_torch.core.plan import PlanChoice, RankedPlan, estimate_cost, \
        extract_features
    from repro_torch.core.program import execute, lower
    from repro_torch.core.spmv import SpmvPlan
    from repro_torch.data.matrices import mixed_structure
    from repro_torch.serve.rebalance import hot_shards, replan

    A = mixed_structure(1024, 33 * 1024, seed=0)
    plan = SpmvPlan(layout="block", distribution="row", reordering="none",
                    exchange="halo", kernel="seg", num_shards=4)
    prog = lower(A, plan)
    cfg = RebalanceConfig(window=16, probe=0)
    mon = LoadMonitor(prog, cfg)
    w = np.ones(A.ncols)
    w[:256] = 50.0                      # traffic on shard 0's x columns
    mon._act_ema = w / w.mean()
    assert list(hot_shards(mon.shard_load(), cfg.hot_factor)) == [0]

    choice = PlanChoice(
        features=extract_features(A, num_shards=4),
        ranking=(RankedPlan(plan=plan, cost=estimate_cost(A, plan)),),
        probed=0)
    dist, new_choice, ev = replan(A, mon, choice, num_shards=4, seed=0,
                                  cfg=cfg, request_index=0, program=prog)
    assert ev.swapped and ev.mode == "partial"
    assert ev.swapped_shards == (0,)
    assert dist.shard_kernels()[0] != "seg"       # hot shard re-kerneled
    assert dist.shard_kernels()[1:] == ("seg",) * 3
    # per-shard double-buffered swap: untouched stages are shared objects
    assert all(dist.stages[p] is prog.stages[p] for p in (1, 2, 3))
    assert dist.stages[0] is not prog.stages[0]
    assert new_choice.plan == dist.plan
    x = np.random.default_rng(0).standard_normal(A.ncols)
    np.testing.assert_allclose(execute(dist, x), csr_matvec(A, x),
                               atol=1e-5, rtol=1e-6)
    # no partial tier when disabled: same trip goes the full route
    cfg_full = RebalanceConfig(window=16, probe=0, partial_first=False)
    _, _, ev_full = replan(A, mon, choice, num_shards=4, seed=0,
                           cfg=cfg_full, request_index=0, program=prog)
    assert ev_full.mode == "full"


def test_partial_replan_reaches_split_on_monster_row_shard():
    """When the hot shard holds monster rows, the partial tier's
    per-shard re-kernel lands on the split family (its per-shard cost
    beats seg there), with the split count derived by the policy at
    relower time — and the swapped program still matches the oracle."""
    from repro_torch.core.plan import PlanChoice, RankedPlan, estimate_cost, \
        extract_features
    from repro_torch.core.program import execute, lower
    from repro_torch.core.spmv import SpmvPlan
    from repro_torch.data.matrices import powerlaw_tail
    from repro_torch.serve.rebalance import hot_shards, replan

    A = powerlaw_tail(2048, 2 * 4 * 2048, n_monster=4, seed=0)
    plan = SpmvPlan(layout="block", distribution="row", reordering="none",
                    exchange="halo", kernel="seg", num_shards=4)
    prog = lower(A, plan)
    cfg = RebalanceConfig(window=16, probe=0)
    mon = LoadMonitor(prog, cfg)
    # skewed toward shard 0's x columns, but mild enough that the
    # traffic-thinned probe structure keeps the monster rows spanning
    # many chunks (heavy thinning would shorten them below the split
    # policy's span floor)
    w = np.ones(A.ncols)
    w[:512] = 3.0
    mon._act_ema = w / w.mean()
    assert list(hot_shards(mon.shard_load(), cfg.hot_factor)) == [0]

    choice = PlanChoice(
        features=extract_features(A, num_shards=4),
        ranking=(RankedPlan(plan=plan, cost=estimate_cost(A, plan)),),
        probed=0)
    dist, new_choice, ev = replan(A, mon, choice, num_shards=4, seed=0,
                                  cfg=cfg, request_index=0, program=prog)
    assert ev.swapped and ev.mode == "partial"
    assert ev.swapped_shards == (0,)
    assert dist.shard_kernels()[0] == "split"
    assert dist.shard_kernels()[1:] == ("seg",) * 3
    assert dist.stages[0].split is not None
    assert dist.stages[0].split.num_splits > 1     # policy-derived count
    assert all(dist.stages[p] is prog.stages[p] for p in (1, 2, 3))
    x = np.random.default_rng(0).standard_normal(A.ncols)
    np.testing.assert_allclose(execute(dist, x), csr_matvec(A, x),
                               atol=1e-4, rtol=1e-5)


def test_partial_replan_reaches_tile_on_blocked_shard():
    """When the hot shard is block-structured (dense (8, 128) tiles), the
    partial tier's per-shard re-kernel lands on the bitmask-tiled family
    — its occupied-tile cost beats every flat format there — while the
    scattered shards keep their kernels, and the swapped program still
    matches the oracle."""
    from repro_torch.core.plan import PlanChoice, RankedPlan, estimate_cost, \
        extract_features
    from repro_torch.core.program import execute, lower
    from repro_torch.core.spmv import SpmvPlan
    from repro_torch.data.matrices import blocked_band
    from repro_torch.serve.rebalance import hot_shards, replan

    A = blocked_band(2048, 215 * 2048, seed=0)
    plan = SpmvPlan(layout="block", distribution="row", reordering="none",
                    exchange="halo", kernel="seg", num_shards=4)
    prog = lower(A, plan)
    cfg = RebalanceConfig(window=16, probe=0)
    mon = LoadMonitor(prog, cfg)
    w = np.ones(A.ncols)
    w[:512] = 3.0                 # skew toward the band shard's columns
    mon._act_ema = w / w.mean()
    assert list(hot_shards(mon.shard_load(), cfg.hot_factor)) == [0]

    choice = PlanChoice(
        features=extract_features(A, num_shards=4),
        ranking=(RankedPlan(plan=plan, cost=estimate_cost(A, plan)),),
        probed=0)
    dist, new_choice, ev = replan(A, mon, choice, num_shards=4, seed=0,
                                  cfg=cfg, request_index=0, program=prog)
    assert ev.swapped and ev.mode == "partial"
    assert ev.swapped_shards == (0,)
    assert dist.shard_kernels()[0] == "tile"
    assert dist.shard_kernels()[1:] == ("seg",) * 3
    assert dist.stages[0].tile is not None
    assert dist.stages[0].tile.num_tiles > 0
    assert all(dist.stages[p] is prog.stages[p] for p in (1, 2, 3))
    x = np.random.default_rng(0).standard_normal(A.ncols)
    np.testing.assert_allclose(execute(dist, x), csr_matvec(A, x),
                               atol=1e-3, rtol=1e-4)


def test_partial_replan_flips_only_hot_shard_exchange():
    """When the hot shard's traffic-thinned halo beats streaming the full
    padded vector, the partial tier flips *only* that shard's exchange
    policy: no stage is rebuilt (exchange is not a lowering-base field,
    every stage object is shared), the flip is logged in
    ``RebalanceEvent.exchange_flips``, and the swapped program still
    matches the oracle."""
    from repro_torch.core.plan import (KERNELS, PlanChoice, RankedPlan,
                                 _active_submatrix, estimate_cost,
                                 extract_features, kernel_shard_costs)
    from repro_torch.core.program import execute, lower
    from repro_torch.core.spmv import SpmvPlan
    from repro_torch.data.matrices import mixed_structure
    from repro_torch.serve.rebalance import hot_shards, replan

    A = mixed_structure(1024, 33 * 1024, seed=0)
    cfg = RebalanceConfig(window=16, probe=0)
    w = np.ones(A.ncols)
    w[:256] = 50.0                      # traffic on shard 0's x columns

    # pin shard 0's kernel to the thinned-structure argmin up front, so
    # the kernel axis is a no-op and the exchange axis acts alone
    part = make_partition(A, 4, "row")
    sub = _active_submatrix(A, w / w.mean(), seed=cfg.seed)
    kc = kernel_shard_costs(sub, part)
    k0 = min(KERNELS, key=lambda k: (kc[k][0], KERNELS.index(k)))
    plan = SpmvPlan(layout="block", distribution="row", reordering="none",
                    exchange="allgather", kernel="seg", num_shards=4,
                    shard_kernels=(k0, "seg", "seg", "seg"))
    prog = lower(A, plan)
    mon = LoadMonitor(prog, cfg)
    mon._act_ema = w / w.mean()
    assert list(hot_shards(mon.shard_load(), cfg.hot_factor)) == [0]

    choice = PlanChoice(
        features=extract_features(A, num_shards=4),
        ranking=(RankedPlan(plan=plan, cost=estimate_cost(A, plan)),),
        probed=0)
    dist, new_choice, ev = replan(A, mon, choice, num_shards=4, seed=0,
                                  cfg=cfg, request_index=0, program=prog)
    assert ev.swapped and ev.mode == "partial"
    assert ev.exchange_flips == (0,)
    assert ev.swapped_shards == ()                 # exchange axis only
    assert "flipped exchange" in ev.reason
    assert dist.plan.resolved_shard_exchanges() == \
        ("halo", "allgather", "allgather", "allgather")
    # a flip rebuilds nothing: every stage object is shared
    assert all(dist.stages[p] is prog.stages[p] for p in range(4))
    assert new_choice.plan == dist.plan
    x = np.random.default_rng(0).standard_normal(A.ncols)
    np.testing.assert_allclose(execute(dist, x), csr_matvec(A, x),
                               atol=1e-5, rtol=1e-6)


def test_partial_replan_needs_skewed_traffic():
    """Uniform traffic never takes the partial tier (nothing local to
    re-derive) — the full tier answers the trip instead."""
    from repro_torch.core.plan import PlanChoice, RankedPlan, estimate_cost, \
        extract_features
    from repro_torch.core.program import lower
    from repro_torch.core.spmv import SpmvPlan
    from repro_torch.serve.rebalance import replan

    A = make_matrix("cop20k_A", scale=0.005)
    plan = SpmvPlan(layout="block", distribution="row", reordering="none",
                    exchange="halo", kernel="ell", num_shards=4)
    prog = lower(A, plan)
    cfg = RebalanceConfig(window=16, probe=2)
    mon = LoadMonitor(prog, cfg)
    mon._act_ema = np.ones(A.ncols)
    choice = PlanChoice(
        features=extract_features(A, num_shards=4),
        ranking=(RankedPlan(plan=plan, cost=estimate_cost(A, plan)),),
        probed=0)
    _, _, ev = replan(A, mon, choice, num_shards=4, seed=0, cfg=cfg,
                      request_index=0, program=prog)
    assert ev.mode == "full"


def test_monitor_batched_requests_count_columns():
    A = make_matrix("ford1", scale=0.05)
    eng = _engine(A)
    mon = eng._matrices["a"].monitor
    X = np.random.default_rng(0).standard_normal((A.ncols, 5))
    eng.spmv("a", X)
    assert mon.requests_seen == 5


def test_drifting_stream_matches_reference_engine():
    """One drifting stream through the reference's engine and the port's
    (``backend="numpy"``): equal events, equal swapped plans, bitwise
    answers."""
    A = r_mat.make_matrix("cop20k_A", scale=0.005)
    ref = r_router.SparseMatrixEngine(
        num_shards=4, rebalance=r_rebalance.RebalanceConfig(
            window=32, patience=2, cooldown=2, probe=2))
    ref.ingest("a", A)
    eng = _engine(_to_port(A))
    hot = _hot_cols(ref)
    np.testing.assert_array_equal(hot, _hot_cols(eng))
    rng = np.random.default_rng(0)
    N, k = A.ncols, max(A.ncols // 20, 8)
    stream = [_request(rng, N, k) for _ in range(2 * CFG.window)] + \
        [_request(rng, N, k, cols=hot) for _ in range(6 * CFG.window)]
    for x in stream:
        assert np.array_equal(eng.spmv("a", x), ref.spmv("a", x))
    want = [e.to_dict() for e in ref.rebalance_log("a")]
    got = [e.to_dict() for e in eng.rebalance_log("a")]
    assert got == want and any(e["swapped"] for e in got)
    assert dataclasses.asdict(eng.plan("a")) == \
        dataclasses.asdict(ref.plan("a"))
    assert eng.stats()["a"]["rebalance"] == ref.stats()["a"]["rebalance"]
