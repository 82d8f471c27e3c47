"""``relower``, ``probe_program`` / ``execute(backend="emu")`` and the
pre-IR aliases of the port against the reference.

``relower``'s stages equal the reference's ``relower`` bitwise (a kernel
swap on two shards, a split request that clamps to the same NS, an
exchange-only change), unchanged stages are the old program's objects,
a base-field change raises ``ValueError``, and the port's executor
(``device="cpu"``) on the relowered program equals it on ``lower(A, p2)``
bitwise.  The Emu backend returns the reference's ``EmuResult``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.emu as r_emu
import repro.core.program as r_program
import repro.core.spmv as r_spmv
import repro.data.matrices as r_mat
from repro.core.spmv import SpmvPlan as RPlan

import repro_torch.core.emu as t_emu
import repro_torch.core.program as t_program
import repro_torch.core.spmv as t_spmv
from repro_torch.core.spmv import SpmvPlan as TPlan

from test_torch_emu import ENGINES, assert_same_result
from test_torch_host import _to_port, assert_same

torch.set_num_threads(1)

BASE = dict(num_shards=4, reordering="bfs", distribution="nonzero")
#: (old plan, new plan, shards whose stages must be rebuilt)
CHANGES = {
    "kernel_swap": (dict(BASE, kernel="seg"),
                    dict(BASE, kernel="seg",
                         shard_kernels=("ell", "seg", "hyb", "seg")), {0, 2}),
    "split_clamps_to_same_ns": (
        dict(BASE, kernel="split", split_counts=(1, 2, 2, 64)),
        dict(BASE, kernel="split", split_counts=(1, 2, 2, 4096)), set()),
    "split_ns_change": (
        dict(BASE, kernel="split", split_counts=(1, 2, 2, 1)),
        dict(BASE, kernel="split", split_counts=(2, 2, 2, 1)), {0}),
    "exchange_only": (
        dict(BASE, kernel="tile"),
        dict(BASE, kernel="tile", exchange="allgather",
             shard_exchanges=("allgather", "halo", "allgather", "halo")),
        set()),
}


def _matrix():
    return r_mat.powerlaw_tail(512, 512 * 8, n_monster=2, seed=5)


@pytest.mark.parametrize("case", sorted(CHANGES))
def test_relower_matches_reference_and_shares_stages(case):
    old, new, rebuilt = CHANGES[case]
    A = _matrix()
    B = _to_port(A)
    rprog = r_program.lower(A, RPlan(**old))
    tprog = t_program.lower(B, TPlan(**old))
    got = t_program.relower(tprog, TPlan(**new))
    assert_same(r_program.relower(rprog, RPlan(**new)), got)
    assert_same(t_program.lower(B, TPlan(**new)), got)
    assert got.plan == TPlan(**new)
    for p, (st_old, st_new) in enumerate(zip(tprog.stages, got.stages)):
        assert (st_new is st_old) == (p not in rebuilt), p
    for f in ("matrix", "partition", "traffic", "shard_traffic", "perm"):
        assert getattr(got, f) is getattr(tprog, f)
    X = np.random.default_rng(2).standard_normal((A.ncols, 3))
    want = t_program.execute(t_program.lower(B, TPlan(**new)), X,
                             backend="device", device="cpu")
    assert np.array_equal(t_program.execute(got, X, backend="device",
                                            device="cpu"), want)
    # the incumbent still answers with its own plan
    np.testing.assert_allclose(
        t_program.execute(tprog, X, backend="device", device="cpu"), want,
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("field,value", [
    ("layout", "cyclic"), ("distribution", "row"), ("reordering", "none"),
    ("num_shards", 2), ("seed", 1)])
def test_relower_rejects_base_changes(field, value):
    B = _to_port(_matrix())
    prog = t_program.lower(B, TPlan(**BASE))
    new = dataclasses.replace(prog.plan, **{field: value})
    with pytest.raises(ValueError, match=field):
        t_program.relower(prog, new)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fields", [dict(kernel="seg"),
                                    dict(BASE, kernel="split",
                                         layout="cyclic")],
                         ids=["seg", "split-bfs-cyclic"])
def test_emu_backend_matches_reference(engine, fields):
    A = _matrix()
    B = _to_port(A)
    fields = dict(fields, num_shards=4)
    rprog = r_program.lower(A, RPlan(**fields))
    tprog = t_program.lower(B, TPlan(**fields))
    want = r_program.execute(rprog, backend="emu", engine="numpy")
    got = t_program.execute(tprog, backend="emu", engine=engine)
    assert isinstance(got, t_emu.EmuResult)
    assert_same_result(got, want)
    cfg = dict(nodelets=4, threads_per_nodelet=8)
    assert_same_result(
        t_program.probe_program(tprog, emu=t_emu.EmuConfig(**cfg),
                                engine=engine),
        r_program.probe_program(rprog, emu=r_emu.EmuConfig(**cfg),
                                engine="numpy"))


def test_pre_ir_aliases():
    A = _matrix()
    B = _to_port(A)
    plan = dict(BASE, kernel="hyb")
    dist = t_spmv.build_distributed(B, TPlan(**plan))
    assert isinstance(dist, t_spmv.DistributedSpmv)
    assert t_spmv.DistributedSpmv is t_program.SpmvProgram
    assert_same(r_spmv.build_distributed(A, RPlan(**plan)), dist)
    X = np.random.default_rng(4).standard_normal((A.ncols, 2))
    assert np.array_equal(t_spmv.local_spmv(dist, X),
                          r_spmv.local_spmv(r_program.lower(
                              A, RPlan(**plan)), X))
    ag = dataclasses.replace(dist.plan, exchange="allgather")
    moved = t_spmv.lower_with_exchange(dist, ag)
    assert moved.plan == ag and moved.stages is dist.stages
    assert np.array_equal(
        t_program.execute(moved, X, backend="device", device="cpu"),
        t_program.execute(dist, X, backend="device", device="cpu"))
    # the halo accounting the pre-IR API read is carried over, bitwise
    assert_same(r_spmv.build_halo(r_program.lower(A, RPlan(**plan))),
                t_spmv.build_halo(dist))
