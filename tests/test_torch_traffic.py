"""The port's traffic accounting and partitions (``repro_torch.core.
migration``, ``core.partition``) held to the reference on the same
matrix: the load-balance measures of Fig. 7 (``mem_instr_cv``,
``inbound_cv``), the hot-spot share, migrations, ``starts_nnz`` and
``make_partition(nnz_weight=)``, all exactly equal; and the reference's
own assertions of ``tests/test_sparse_core.py::TestTraffic`` on the port.
"""
import numpy as np
import pytest

from repro.core import layout as r_layout
from repro.core import migration as r_migration
from repro.core import partition as r_partition
from repro.core import reorder as r_reorder
from repro.data import matrices as r_matrices
from repro_torch.core import layout as t_layout
from repro_torch.core import migration as t_migration
from repro_torch.core import partition as t_partition
from repro_torch.core import reorder as t_reorder
from repro_torch.data import matrices as t_matrices

P = 8


@pytest.fixture(scope="module")
def mats():
    """cop20k_A at scale 0.02, unreordered and under ``random`` (the
    reference test's default seed), built by each package."""
    ref = r_matrices.make_matrix("cop20k_A", scale=0.02)
    port = t_matrices.make_matrix("cop20k_A", scale=0.02)
    return {False: (ref, port),
            True: (r_reorder.reorder(ref, "random"),
                   t_reorder.reorder(port, "random"))}


def _reports(mats, strategy, shuffled):
    ref, port = mats[shuffled]
    r = r_migration.count_migrations(
        ref, r_partition.make_partition(ref, P, strategy),
        r_layout.make_layout("block", ref.ncols, P),
        r_layout.make_layout("block", ref.nrows, P))
    t = t_migration.count_migrations(
        port, t_partition.make_partition(port, P, strategy),
        t_layout.make_layout("block", port.ncols, P),
        t_layout.make_layout("block", port.nrows, P))
    return r, t


@pytest.mark.parametrize("strategy,shuffled",
                         [("row", False), ("nonzero", False),
                          ("row", True), ("nonzero", True)],
                         ids=["row", "nonzero", "row-random",
                              "nonzero-random"])
def test_traffic_measures_equal_reference(mats, strategy, shuffled):
    r, t = _reports(mats, strategy, shuffled)
    for name in ("mem_instr_cv", "inbound_cv", "hotspot_share",
                 "migrations", "remote_x_loads", "remote_b_updates"):
        assert getattr(t, name) == getattr(r, name), name
    for name in ("mem_instr_per_nodelet", "inbound_x_loads",
                 "nnz_per_nodelet"):
        np.testing.assert_array_equal(getattr(t, name), getattr(r, name))
    assert isinstance(t.mem_instr_cv, float) and t.mem_instr_cv > 0
    assert isinstance(t.inbound_cv, float) and t.inbound_cv > 0


def test_nonzero_lower_cv(mats):
    """Fig. 7 on the port: the nonzero split's memory instructions vary
    less across nodelets than the row split's."""
    _, cv_row = (rep.mem_instr_cv for rep in _reports(mats, "row", False))
    _, cv_nnz = (rep.mem_instr_cv for rep in _reports(mats, "nonzero", False))
    assert cv_nnz < cv_row


def test_random_kills_hotspot(mats):
    """On the port, a random order spreads the x loads the nodelets
    serve and costs migrations."""
    _, r0 = _reports(mats, "nonzero", False)
    _, r1 = _reports(mats, "nonzero", True)
    assert r1.inbound_cv < 0.3 * r0.inbound_cv
    assert r1.migrations > r0.migrations


@pytest.mark.parametrize("strategy", ["row", "nonzero"])
def test_starts_nnz(mats, strategy):
    ref, port = mats[False]
    rp = r_partition.make_partition(ref, P, strategy)
    tp = t_partition.make_partition(port, P, strategy)
    got = tp.starts_nnz(port)
    np.testing.assert_array_equal(got, rp.starts_nnz(ref))
    np.testing.assert_array_equal(got, tp.nnz_per_shard(port))
    assert got.sum() == port.nnz


@pytest.mark.parametrize("strategy", ["nonzero", "nnz"])
def test_make_partition_nnz_weight(mats, strategy):
    """The weighted nonzero split reaches ``make_partition``: bitwise the
    reference's and ``partition_nonzeros``'s, and not the unweighted one."""
    ref, port = mats[False]
    w = np.random.default_rng(0).exponential(size=port.nnz)
    got = t_partition.make_partition(port, P, strategy, nnz_weight=w)
    want = r_partition.make_partition(ref, P, strategy, nnz_weight=w)
    direct = t_partition.partition_nonzeros(port, P, nnz_weight=w)
    assert got.starts.dtype == want.starts.dtype
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.starts, direct.starts)
    assert got.strategy == want.strategy == "nonzero"
    plain = t_partition.make_partition(port, P, strategy)
    assert not np.array_equal(got.starts, plain.starts)


def test_make_partition_row_ignores_nnz_weight(mats):
    ref, port = mats[False]
    w = np.random.default_rng(1).exponential(size=port.nnz)
    got = t_partition.make_partition(port, P, "row", nnz_weight=w)
    np.testing.assert_array_equal(
        got.starts, t_partition.make_partition(port, P, "row").starts)
    np.testing.assert_array_equal(
        got.starts, r_partition.make_partition(ref, P, "row",
                                               nnz_weight=w).starts)


@pytest.mark.parametrize("arrays", [
    (np.zeros(P, np.int64), np.zeros(P, np.int64)),
    (np.zeros(P, np.int64), np.arange(P, dtype=np.int64)),
    (np.arange(P, dtype=np.int64), np.zeros(P, np.int64)),
], ids=["both-zero", "no-mem-instr", "no-inbound"])
def test_mean_zero_gives_zero(arrays):
    """A measure whose mean is 0 is 0.0, as in the reference."""
    mem, inbound = arrays
    fields = dict(migrations=0, remote_x_loads=0, remote_b_updates=0,
                  mem_instr_per_nodelet=mem, inbound_x_loads=inbound,
                  nnz_per_nodelet=np.zeros(P, np.int64))
    t = t_migration.TrafficReport(**fields)
    r = r_migration.TrafficReport(**fields)
    for name in ("mem_instr_cv", "inbound_cv", "hotspot_share"):
        assert getattr(t, name) == getattr(r, name), name
    if not mem.any():
        assert t.mem_instr_cv == 0.0
    if not inbound.any():
        assert t.inbound_cv == 0.0 and t.hotspot_share == 0.0
