"""The port's planner equals the reference's: features, the cost tables
and selectors, ``estimate_cost``, ``autotune`` (its JSON string-equal for
``probe`` 0, 2 and ``"auto"``, with ``col_weight`` and with the uniform
grid), ``PlanChoice`` JSON read across packages and from the frozen
fixtures, ``PlanCache``, the ``CostOracle`` and ``SpmvPlan.auto``."""
import dataclasses
import doctest
import json
import pathlib

import numpy as np
import pytest

import repro.core.emu as r_emu
import repro.core.layout as r_layout
import repro.core.migration as r_migration
import repro.core.oracle as r_oracle
import repro.core.partition as r_partition
import repro.core.plan as r_plan
from repro.core.spmv import SpmvPlan as RPlan

import repro_torch.core.layout as t_layout
import repro_torch.core.migration as t_migration
import repro_torch.core.oracle as t_oracle
import repro_torch.core.partition as t_partition
import repro_torch.core.plan as t_plan
from repro_torch.core.spmv import SpmvPlan as TPlan

from test_torch_emu import GENERATORS, _matrices, assert_same_result
from test_torch_host import assert_same

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
PLANS = [
    dict(kernel="ell"),
    dict(kernel="seg", reordering="bfs", distribution="nonzero"),
    dict(kernel="hyb", layout="cyclic", exchange="allgather"),
    dict(kernel="split", distribution="row", reordering="metis"),
    dict(kernel="tile", reordering="degree"),
    dict(kernel="seg", reordering="random",
         shard_kernels=("tile", "split", "hyb", "seg"),
         shard_exchanges=("halo", "allgather", "allgather", "halo")),
]


@pytest.fixture(scope="module", params=sorted(GENERATORS))
def matrix(request):
    return _matrices(request.param)


def _col_weight(n, seed=3):
    """Skewed per-column activity with some cold columns."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(1.5, n)
    w[rng.random(n) < 0.3] = 0.0
    return w


def _parts(A, B, S, distribution):
    return (r_partition.make_partition(A, S, distribution),
            t_partition.make_partition(B, S, distribution))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_features_and_key_bitwise(matrix, S):
    A, B = matrix
    got = t_plan.extract_features(B, num_shards=S)
    want = r_plan.extract_features(A, num_shards=S)
    assert got.to_dict() == want.to_dict()
    assert t_plan.feature_key(got) == r_plan.feature_key(want)


@pytest.mark.parametrize("distribution", ["row", "nonzero"])
@pytest.mark.parametrize("layout", ["block", "cyclic"])
def test_shard_tables_and_selectors_bitwise(matrix, distribution, layout):
    A, B = matrix
    rp, tp = _parts(A, B, 4, distribution)
    assert_same(t_plan.extract_shard_features(B, tp),
                r_plan.extract_shard_features(A, rp))
    costs = t_plan.kernel_shard_costs(B, tp)
    assert_same(costs, r_plan.kernel_shard_costs(A, rp))
    for kernels in (t_plan.KERNELS, ("seg", "split"), ("tile", "ell")):
        assert t_plan.select_shard_kernels(B, tp, kernels=kernels) == \
            r_plan.select_shard_kernels(A, rp, kernels=kernels)
    assert_same(t_plan.exchange_shard_costs(B, tp, layout),
                r_plan.exchange_shard_costs(A, rp, layout))
    assert t_plan.select_shard_exchanges(B, tp, layout) == \
        r_plan.select_shard_exchanges(A, rp, layout)
    assert_same(t_plan.remote_row_share(B, tp, layout),
                r_plan.remote_row_share(A, rp, layout))
    for fields in PLANS:
        fields = dict(fields, layout=layout, num_shards=4)
        assert t_plan.device_path_model(B, tp, TPlan(**fields)) == \
            r_plan.device_path_model(A, rp, RPlan(**fields))


@pytest.mark.parametrize("layout", ["block", "cyclic"])
def test_migration_arrivals_and_load_map_bitwise(matrix, layout):
    A, B = matrix
    rp, tp = _parts(A, B, 8, "nonzero")
    rl = r_layout.make_layout(layout, A.ncols, 8)
    tl = t_layout.make_layout(layout, B.ncols, 8)
    for w in (None, _col_weight(A.ncols)):
        assert_same(t_migration.migration_arrivals(B, tp, tl, col_weight=w),
                    r_migration.migration_arrivals(A, rp, rl, col_weight=w))
    assert_same(t_migration.shard_load_map(B, tp, tl),
                r_migration.shard_load_map(A, rp, rl))
    rb = r_layout.make_layout("cyclic", A.nrows, 8)
    tb = t_layout.make_layout("cyclic", B.nrows, 8)
    assert_same(t_migration.shard_load_map(B, tp, tl, tb),
                r_migration.shard_load_map(A, rp, rl, rb))


@pytest.mark.parametrize("fields", PLANS, ids=lambda f: "-".join(
    str(v) if not isinstance(v, tuple) else "mixed" for v in f.values()))
def test_estimate_cost_bitwise(matrix, fields):
    A, B = matrix
    fields = dict(fields, num_shards=4)
    assert t_plan.estimate_cost(B, TPlan(**fields)).to_dict() == \
        r_plan.estimate_cost(A, RPlan(**fields)).to_dict()
    w = _col_weight(A.ncols)
    assert t_plan.estimate_cost(B, TPlan(**fields), col_weight=w).to_dict() \
        == r_plan.estimate_cost(A, RPlan(**fields), col_weight=w).to_dict()


@pytest.mark.parametrize("probe", [0, 2, "auto"])
def test_autotune_json_string_equal(matrix, probe):
    A, B = matrix
    got = t_plan.autotune(B, num_shards=4, probe=probe)
    want = r_plan.autotune(A, num_shards=4, probe=probe)
    assert got.to_json() == want.to_json()
    assert got.probed == want.probed


def test_autotune_col_weight_and_uniform_grid(matrix):
    A, B = matrix
    w = _col_weight(A.ncols)
    assert t_plan.autotune(B, num_shards=4, probe=2, col_weight=w).to_json() \
        == r_plan.autotune(A, num_shards=4, probe=2, col_weight=w).to_json()
    uniform = t_plan.autotune(B, num_shards=4, probe=0, per_shard=False)
    assert uniform.to_json() == r_plan.autotune(
        A, num_shards=4, probe=0, per_shard=False).to_json()
    assert all(r.plan.shard_kernels is None for r in uniform.ranking)


def test_autotune_rejects_unknown_probe_string():
    _, B = _matrices("mixed_structure")
    with pytest.raises(ValueError, match="probe"):
        t_plan.autotune(B, num_shards=2, probe="sometimes")


def test_plan_choice_json_read_across_packages():
    A, B = _matrices("powerlaw_tail")
    r_json = r_plan.autotune(A, num_shards=4, probe=2).to_json()
    t_choice = t_plan.autotune(B, num_shards=4, probe=2)
    t_json = t_choice.to_json()
    assert t_plan.PlanChoice.from_json(r_json) == t_choice
    assert r_plan.PlanChoice.from_json(t_json).to_json() == r_json
    assert t_plan.PlanChoice.from_json(t_json).to_json(indent=1) == \
        r_plan.PlanChoice.from_json(r_json).to_json(indent=1)


@pytest.mark.parametrize("name", ["plan_choice_pre_shard_kernels.json",
                                  "plan_choice_pre_shard_exchanges.json"])
def test_frozen_plan_choice_fixtures_load(name):
    raw = (FIXTURES / name).read_text()
    got = t_plan.PlanChoice.from_json(raw)
    want = r_plan.PlanChoice.from_json(raw)
    assert got.to_json() == want.to_json()
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    assert isinstance(got.plan, TPlan)
    assert t_plan.PlanChoice.from_json(got.to_json()) == got


def test_plan_cache_hits_and_misses(tmp_path):
    mem = t_plan.PlanCache()
    mem.put(("fk1", 8), TPlan(kernel="seg"))
    assert mem.get(("fk1", 8)) == TPlan(kernel="seg")
    assert mem.get(("fk1", 9)) is None and len(mem) == 1

    plan = TPlan(kernel="split", num_shards=2, split_counts=(1, 4),
                 shard_kernels=("seg", "split"))
    disk = t_plan.PlanCache(str(tmp_path / "port"))
    disk.put(("fk1", 2), plan)
    again = t_plan.PlanCache(str(tmp_path / "port"))     # a new process
    assert again.get(("fk1", 2)) == plan and len(again) == 1
    assert again.get(("fk1", 3)) is None
    # the reference's files read the same, and the port's in the reference
    r_cache = r_plan.PlanCache(str(tmp_path / "port"))
    assert dataclasses.asdict(r_cache.get(("fk1", 2))) == \
        dataclasses.asdict(plan)
    r_plan.PlanCache(str(tmp_path / "ref")).put(("fk2", 2), RPlan(
        kernel="tile", num_shards=2))
    assert t_plan.PlanCache(str(tmp_path / "ref")).get(("fk2", 2)) == \
        TPlan(kernel="tile", num_shards=2)
    # a corrupt file and a hash collision read as misses
    corrupt = t_plan.PlanCache(str(tmp_path / "port"))
    with open(corrupt._path(("fk1", 2)), "w") as f:
        f.write("{not json")
    assert corrupt.get(("fk1", 2)) is None
    path = corrupt._path(("fk9", 2))
    with open(path, "w") as f:
        json.dump({"key": repr(("other",)), "plan": {}}, f)
    assert corrupt.get(("fk9", 2)) is None


def test_oracle_constants_and_default():
    for name in ("BOTTLENECK_CLASSES", "REPLAN_SPMV_EQUIV", "IMBALANCE_ROW_CV",
                 "IMBALANCE_TAIL_SHARE", "IMBALANCE_HOT_COL",
                 "LATENCY_REMOTE_FRAC"):
        assert getattr(t_oracle, name) == getattr(r_oracle, name)
    for name in ("DEFAULT_PROBE", "AUTO_PROBE_MIN", "AUTO_PROBE_STREAK",
                 "AUTO_PROBE_TOL", "KERNELS", "SPLIT_CORES", "SPLIT_MIN_SPAN"):
        assert getattr(t_plan, name) == getattr(r_plan, name)
    for name in dir(r_plan):
        if name.startswith("_W_"):
            assert getattr(t_plan, name) == getattr(r_plan, name), name
    assert isinstance(t_oracle.DEFAULT_ORACLE, t_oracle.CostOracle)
    assert t_oracle.DEFAULT_ORACLE.emu is None


def test_oracle_decisions_match(matrix):
    A, B = matrix
    ro, to = r_oracle.DEFAULT_ORACLE, t_oracle.DEFAULT_ORACLE
    rf, tf = r_plan.extract_features(A), t_plan.extract_features(B)
    assert to.classify(tf) == ro.classify(rf)
    rp, tp = _parts(A, B, 4, "nonzero")
    rsf = r_plan.extract_shard_features(A, rp)
    tsf = t_plan.extract_shard_features(B, tp)
    for frac in (0.0, tf.remote_frac, 0.9):
        assert to.classify_shards(tsf, frac) == ro.classify_shards(rsf, frac)
    for cls in t_oracle.BOTTLENECK_CLASSES:
        assert to.kernel_affinity(cls) == ro.kernel_affinity(cls)
    plan = dict(kernel="split", num_shards=4, reordering="bfs")
    rc = ro.plan_cost(A, RPlan(**plan))
    tc = to.plan_cost(B, TPlan(**plan))
    assert tc.to_dict() == rc.to_dict()
    for cls in t_oracle.BOTTLENECK_CLASSES:
        assert to.score(tc, cls) == ro.score(rc, cls)
    with pytest.raises(ValueError, match="bottleneck"):
        to.score(tc, "thermal")
    with pytest.raises(ValueError, match="bottleneck"):
        to.kernel_affinity("thermal")
    assert [to.split_span_ok(B, tp, p) for p in range(4)] == \
        [ro.split_span_ok(A, rp, p) for p in range(4)]
    assert to.select_kernels(B, tp) == ro.select_kernels(A, rp)
    assert to.select_exchanges(B, tp, "cyclic") == \
        ro.select_exchanges(A, rp, "cyclic")
    assert to.device_path(B, tp, TPlan(**plan)) == \
        ro.device_path(A, rp, RPlan(**plan))


@pytest.mark.parametrize("gain,horizon,mode", [
    (0.1, None, "full"), (-0.1, None, "full"), (0.1, 100.0, "full"),
    (0.1, 500.0, "full"), (0.02, 100.0, "partial"), (0.0, 10.0, "partial")])
def test_oracle_replan_gate_matches(gain, horizon, mode):
    got = t_oracle.DEFAULT_ORACLE.replan_pays(gain, horizon, mode)
    want = r_oracle.DEFAULT_ORACLE.replan_pays(gain, horizon, mode)
    assert got.to_dict() == want.to_dict()
    with pytest.raises(ValueError, match="re-plan mode"):
        t_oracle.DEFAULT_ORACLE.replan_pays(gain, horizon, "sideways")


@pytest.mark.parametrize("kernel_aware", [True, False])
def test_oracle_probe_matches(kernel_aware):
    A, B = _matrices("halo_spikes")
    plan = dict(kernel="seg", num_shards=4, reordering="bfs", layout="cyclic",
                shard_kernels=("seg", "ell", "split", "tile"))
    w = _col_weight(A.ncols)
    for cw in (None, w):
        assert t_oracle.DEFAULT_ORACLE.probe_seconds(
            B, TPlan(**plan), col_weight=cw, kernel_aware=kernel_aware) == \
            r_oracle.DEFAULT_ORACLE.probe_seconds(
                A, RPlan(**plan), col_weight=cw, kernel_aware=kernel_aware)
    rp, tp = _parts(A, B, 4, "row")
    cfg = dict(nodelets=4, threads_per_nodelet=16)
    assert_same_result(
        t_oracle.CostOracle(t_plan.EmuConfig(**cfg)).probe(
            B, tp, TPlan(**plan), kernel_aware=kernel_aware),
        r_oracle.CostOracle(r_emu.EmuConfig(**cfg)).probe(
            A, rp, RPlan(**plan), kernel_aware=kernel_aware, engine="numpy"))


@pytest.mark.parametrize("name", ["cop20k_A", "powerlaw_tail"])
@pytest.mark.parametrize("probe", [None, "auto"])
def test_spmv_plan_auto_matches(name, probe):
    A, B = _matrices(name)
    got = TPlan.auto(B, num_shards=4, probe=probe)
    assert isinstance(got, TPlan)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        RPlan.auto(A, num_shards=4, probe=probe))


def test_plan_module_doctests():
    result = doctest.testmod(t_plan, verbose=False)
    assert result.failed == 0 and result.attempted > 0
