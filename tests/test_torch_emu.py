"""The port's Emu simulator and cache model equal the reference's.

``build_thread_traces`` arrays and the ``EmuResult`` of every engine
(``vectorized``, ``cext``, ``numpy`` and the per-thread ``reference``
loop) are compared with the JAX package's on the same seeded matrices,
both layouts and both distributions, with and without format-shaped
``shard_kernels`` streams: ticks, migrations, seconds, per-nodelet
instruction counts and residency traces must be equal exactly.  The
``cext`` cases skip without a C compiler; ``REPRO_EMU_DISABLE_CEXT=1``
with the loader's cache reset must fall back to the numpy engine.
"""
import functools
import os
import shutil

import numpy as np
import pytest

import repro.core.cache_model as r_cache
import repro.core.emu as r_emu
import repro.core.layout as r_layout
import repro.core.partition as r_partition
import repro.data.matrices as r_mat

import repro_torch.core._emu_cext as t_cext
import repro_torch.core.cache_model as t_cache
import repro_torch.core.emu as t_emu
import repro_torch.core.layout as t_layout
import repro_torch.core.partition as t_partition

from test_torch_host import _to_port, assert_same

HAS_CC = bool(shutil.which("cc") or shutil.which("gcc")
              or shutil.which("clang"))
ENGINES = ["vectorized", "numpy",
           pytest.param("cext", marks=pytest.mark.skipif(
               not HAS_CC, reason="no C compiler for the tick kernel"))]
#: Small machine, so the per-thread reference loop stays cheap and the
#: queue small enough that throttling and backpressure fire.
SMALL = dict(nodelets=4, threads_per_nodelet=16, migration_queue_cap=8,
             me_rate=3, ingress_rate=3, resident_cap=20,
             latency_hide_threads=8)
MIXED_KERNELS = ("ell", "seg", "hyb", "split", "tile", "seg", "ell", "tile")
#: Five structures, small enough that a simulation takes well under a
#: second on the numpy engine.
GENERATORS = {
    "mixed_structure": lambda: r_mat.mixed_structure(256, 256 * 6, seed=0),
    "blocked_band": lambda: r_mat.blocked_band(256, 256 * 16, seed=1),
    "powerlaw_tail": lambda: r_mat.powerlaw_tail(2048, 2048 * 4, n_monster=2,
                                                 seed=2),
    "halo_spikes": lambda: r_mat.halo_spikes(256, 256 * 8, seed=3),
    "cop20k_A": lambda: r_mat.make_matrix("cop20k_A", scale=0.002, seed=4),
}


@functools.lru_cache(maxsize=None)
def _matrices(name):
    A = GENERATORS[name]()
    return A, _to_port(A)


@pytest.fixture(scope="module", params=sorted(GENERATORS))
def matrix(request):
    return _matrices(request.param)


@functools.lru_cache(maxsize=None)
def _reference_run(name, layout, distribution, kernels=None):
    A, _ = _matrices(name)
    rp = r_partition.make_partition(A, 8, distribution)
    return r_emu.run_spmv(A, rp, r_layout.make_layout(layout, A.ncols, 8),
                          engine="numpy", shard_kernels=kernels)


def _walk(A, B, S, layout, distribution):
    rp = r_partition.make_partition(A, S, distribution)
    tp = t_partition.make_partition(B, S, distribution)
    return (rp, r_layout.make_layout(layout, A.ncols, S)), \
        (tp, t_layout.make_layout(layout, B.ncols, S))


def assert_same_result(a, b):
    assert (a.ticks, a.migrations, a.seconds, a.bandwidth_mbs,
            a.sample_every) == (b.ticks, b.migrations, b.seconds,
                                b.bandwidth_mbs, b.sample_every)
    assert_same(a.instr_per_nodelet, b.instr_per_nodelet)
    assert_same(a.residency, b.residency)


def test_useful_bytes_and_config(matrix):
    A, B = matrix
    assert t_emu.useful_bytes(B) == r_emu.useful_bytes(A)
    assert t_emu.EmuConfig() == t_emu.EmuConfig(**vars(r_emu.EmuConfig()))


@pytest.mark.parametrize("layout", ["block", "cyclic"])
@pytest.mark.parametrize("distribution", ["row", "nonzero"])
@pytest.mark.parametrize("kernels", [None, MIXED_KERNELS],
                         ids=["csr_walk", "shard_kernels"])
def test_thread_traces_bitwise(matrix, layout, distribution, kernels):
    A, B = matrix
    (rp, rl), (tp, tl) = _walk(A, B, 8, layout, distribution)
    assert_same(tp.thread_splits(B, 16), rp.thread_splits(A, 16))
    assert_same(t_emu.build_thread_traces(B, tp, tl, 16,
                                          shard_kernels=kernels),
                r_emu.build_thread_traces(A, rp, rl, 16,
                                          shard_kernels=kernels))


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("layout", ["block", "cyclic"])
@pytest.mark.parametrize("distribution", ["row", "nonzero"])
def test_run_spmv_bitwise(name, engine, layout, distribution):
    """The default machine (8 nodelets, 64 threads each) on every engine
    of the port against the reference's numpy engine."""
    A, B = _matrices(name)
    (rp, rl), (tp, tl) = _walk(A, B, 8, layout, distribution)
    want = _reference_run(name, layout, distribution)
    got = t_emu.run_spmv(B, tp, tl, engine=engine)
    assert got.ticks < t_emu.EmuConfig().max_ticks
    assert_same_result(got, want)
    assert got.instr_cv == want.instr_cv
    assert got.residency_cv == want.residency_cv


@pytest.mark.parametrize("engine", ENGINES + ["reference"])
@pytest.mark.parametrize("kernels", [None, MIXED_KERNELS[:4]],
                         ids=["csr_walk", "shard_kernels"])
def test_simulate_small_machine_bitwise(matrix, engine, kernels):
    """A congested small machine: each engine of the port against the
    reference's per-thread loop on the same traces."""
    A, B = matrix
    rcfg, tcfg = r_emu.EmuConfig(**SMALL), t_emu.EmuConfig(**SMALL)
    (rp, rl), (tp, tl) = _walk(A, B, 4, "cyclic", "nonzero")
    want = r_emu.simulate(*r_emu.build_thread_traces(
        A, rp, rl, 16, shard_kernels=kernels), rcfg, 1e6, engine="reference")
    got = t_emu.simulate(*t_emu.build_thread_traces(
        B, tp, tl, 16, shard_kernels=kernels), tcfg, 1e6, engine=engine)
    assert_same_result(got, want)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_run_spmv_shard_kernels_bitwise(name):
    A, B = _matrices(name)
    (_, _), (tp, tl) = _walk(A, B, 8, "block", "nonzero")
    assert_same_result(
        t_emu.run_spmv(B, tp, tl, shard_kernels=MIXED_KERNELS),
        _reference_run(name, "block", "nonzero", MIXED_KERNELS))


def test_unknown_engine_and_kernel_raise():
    _, B = _matrices("mixed_structure")
    tp = t_partition.make_partition(B, 4, "row")
    tl = t_layout.make_layout("block", B.ncols, 4)
    with pytest.raises(ValueError, match="engine"):
        t_emu.run_spmv(B, tp, tl, engine="gpu")
    with pytest.raises(ValueError, match="kernel format"):
        t_emu.build_thread_traces(B, tp, tl, 4, shard_kernels=("bsr",) * 4)
    with pytest.raises(ValueError, match="entries"):
        t_emu.build_thread_traces(B, tp, tl, 4, shard_kernels=("ell",))


@pytest.fixture
def fresh_loader(monkeypatch):
    """The C loader with its per-process cache reset (restored after)."""
    monkeypatch.setattr(t_cext, "_kernel", None)
    monkeypatch.setattr(t_cext, "_load_attempted", False)
    return monkeypatch


def test_disable_cext_falls_back_to_numpy(fresh_loader):
    fresh_loader.setenv("REPRO_EMU_DISABLE_CEXT", "1")
    A, B = _matrices("powerlaw_tail")
    (_, _), (tp, tl) = _walk(A, B, 8, "cyclic", "row")
    assert t_cext.load_kernel() is None
    with pytest.raises(RuntimeError, match="REPRO_EMU_DISABLE_CEXT"):
        t_emu.run_spmv(B, tp, tl, engine="cext")
    assert_same_result(t_emu.run_spmv(B, tp, tl),
                       _reference_run("powerlaw_tail", "cyclic", "row"))


@pytest.mark.skipif(not HAS_CC, reason="no C compiler for the tick kernel")
def test_cext_builds_under_the_port_build_dir(fresh_loader):
    """The port's shared object is built from its own source under
    ``build/repro_torch/emu`` and is not the reference's."""
    fresh_loader.delenv("REPRO_EMU_DISABLE_CEXT", raising=False)
    assert t_cext.load_kernel() is not None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert t_cext.BUILD_DIR == os.path.join(root, "build", "repro_torch",
                                            "emu")
    so = t_cext._compile(t_cext._SRC)
    assert os.path.dirname(so) in (
        t_cext.BUILD_DIR, os.path.join(t_cext.tempfile.gettempdir(),
                                       "repro_torch-emu"))
    assert os.path.dirname(t_cext._SRC).endswith(
        os.path.join("repro_torch", "core"))


def test_cache_models_bitwise(matrix):
    A, B = matrix
    assert t_cache.analytic_cache_model(B) == r_cache.analytic_cache_model(A)
    assert t_cache.analytic_cache_model(B, line_elems=4, llc_bytes=2**12) \
        == r_cache.analytic_cache_model(A, line_elems=4, llc_bytes=2**12)
    assert t_cache.analytic_tile_cache_model(B) == \
        r_cache.analytic_tile_cache_model(A)
    assert t_cache.analytic_tile_cache_model(B, bm=16, bn=64) == \
        r_cache.analytic_tile_cache_model(A, bm=16, bn=64)
    x = np.random.default_rng(5).standard_normal(A.ncols)
    assert_same(t_cache._csr_spmv_numpy(B, x), r_cache._csr_spmv_numpy(A, x))


def test_measure_cpu_spmv_reports_consistent_rates():
    _, B = _matrices("cop20k_A")
    r = t_cache.measure_cpu_spmv(B, trials=2, warmup=1)
    assert r.seconds > 0
    assert r.bandwidth_mbs == pytest.approx(
        8.0 * (3 * B.nnz + 2 * B.nrows) / r.seconds / 1e6)
    assert r.gflops == pytest.approx(2.0 * B.nnz / r.seconds / 1e9)
