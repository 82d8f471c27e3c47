"""The pre-IR surface of the port against the reference: the legacy
stacked-slab views of ``SpmvProgram`` and ``build_halo`` (bitwise, on
ell/hyb/seg/split/tile programs at S = 2 and 4), ``SpmvPlan.retarget``
(equal plans), and the deprecated ``make_*_fn`` shims: each warns once,
re-binds the exchange as the reference does, answers on the CPU bitwise
as ``make_program_spmv_fn`` on the re-bound program, and within
|A|·|x|-scaled 2e-4 of the reference's float64 ``execute``.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.core.program as r_program
import repro.core.spmv as r_spmv
import repro.data.matrices as r_mat
from repro.core.sparse_matrix import csr_matvec
from repro.core.spmv import SpmvPlan as RPlan

import repro_torch.core.program as t_program
import repro_torch.core.spmv as t_spmv
from repro_torch.core.spmv import PLAN_KERNELS
from repro_torch.core.spmv import SpmvPlan as TPlan

from test_torch_host import _to_port, assert_same

torch.set_num_threads(1)

TOL = 2e-4
VIEWS = ("data", "cols", "seg_vals", "seg_cols", "seg_rows", "seg_pieces")


def _matrix():
    return r_mat.mixed_structure(384, 384 * 6, seed=1)


def _programs(fields):
    A = _matrix()
    return A, r_program.lower(A, RPlan(**fields)), \
        t_program.lower(_to_port(A), TPlan(**fields))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("kernel", PLAN_KERNELS)
def test_legacy_views_and_halo_match_reference(kernel, S):
    _, rp, tp = _programs(dict(num_shards=S, kernel=kernel,
                               reordering="bfs"))
    for name in VIEWS:
        want, got = getattr(rp, name), getattr(tp, name)
        if want is None:                     # seg views: uniform seg only
            assert got is None and kernel != "seg", name
            continue
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert getattr(tp, "data") is getattr(tp, "data")       # built once
    assert_same(r_spmv.build_halo(rp), t_spmv.build_halo(tp))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_retarget_matches_reference(n):
    base = dict(num_shards=4, kernel="seg", exchange="halo",
                shard_kernels=("ell", "seg", "split", "tile"),
                split_counts=(1, 1, 4, 1),
                shard_exchanges=("halo", "allgather", "halo", "halo"))
    for fields in (base, dict(base, shard_kernels=None),
                   dict(num_shards=2, kernel="tile")):
        got = TPlan(**fields).retarget(n)
        want = RPlan(**fields).retarget(n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got == TPlan(**dataclasses.asdict(want))


def _shim_case(name, tp, rp):
    """(shim, its arguments before x, the exchange it re-binds to)."""
    if name == "make_spmv_fn":
        return t_spmv.make_spmv_fn(tp, device="cpu"), \
            (rp.data, rp.cols), "allgather"
    if name == "make_seg_spmv_fn":
        return t_spmv.make_seg_spmv_fn(tp, device="cpu"), \
            (rp.seg_vals, rp.seg_cols, rp.seg_rows, rp.seg_pieces), \
            "allgather"
    halo = t_spmv.build_halo(tp)
    return t_spmv.make_halo_spmv_fn(tp, halo, device="cpu"), \
        (tp.data, halo.cols_remap, halo.send_idx), "halo"


@pytest.mark.parametrize("exchange", ["halo", "allgather"])
@pytest.mark.parametrize("name", ["make_spmv_fn", "make_seg_spmv_fn",
                                  "make_halo_spmv_fn"])
def test_shims_warn_once_and_answer_as_the_executor(monkeypatch, name,
                                                    exchange):
    monkeypatch.setattr(t_spmv, "_DEPRECATION_WARNED", set())
    A, rp, tp = _programs(dict(num_shards=4, kernel="seg", exchange=exchange,
                               layout="cyclic"))
    with pytest.warns(DeprecationWarning, match=name):
        fn, args, rebound = _shim_case(name, tp, rp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # the second shim is silent
        _shim_case(name, tp, rp)
    x = np.random.default_rng(3).standard_normal((A.ncols, 3))
    xs = tp.x_to_device(t_program._apply_perm(x, tp.perm).astype(np.float32))
    got = fn(*args, xs)
    plan = dataclasses.replace(tp.plan, exchange=rebound)
    inner = t_program.make_program_spmv_fn(
        t_spmv.lower_with_exchange(tp, plan), device="cpu")(xs)
    if name == "make_seg_spmv_fn":
        inner = inner[:, : int(tp.rows_per_shard.max())]
    assert torch.equal(got, inner)
    y = t_program.gather_b(tp, got)
    want = r_program.execute(rp, x)
    absA = dataclasses.replace(A, values=np.abs(A.values))
    scale = 1.0 + csr_matvec(absA, np.abs(x))
    assert (np.abs(y - want) / scale).max() <= TOL
    if name == "make_seg_spmv_fn":
        _, _, tile = _programs(dict(num_shards=4, kernel="tile"))
        with pytest.raises(ValueError, match="kernel='seg'"):
            t_spmv.make_seg_spmv_fn(tile, device="cpu")
