"""The port's SpMV serving router against the reference's.

The SpMV tests of ``tests/test_serve_engine.py`` run on
``repro_torch.serve.SparseMatrixEngine`` under both backends: with
``backend="numpy"`` every answer is bitwise the reference engine's on the
same ingest; with ``backend="device", device="cpu"`` (the executor's
plain PyTorch versions, float32) every answer is within |A|·|x|-scaled
2e-4 of ``csr_matvec``, and batched and micro-batched columns are bitwise
the solo calls.  A bundle the reference engine wrote warm-starts the
port's engine, and ``device="cuda"`` without a GPU raises when the engine
is built.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core.program as r_program
import repro.serve.router as r_router
from repro.core.sparse_matrix import csr_matvec, csr_to_dense
from repro.core.spmv import SpmvPlan as RPlan
from repro.data.matrices import make_matrix

import repro_torch.core.program as t_program
import repro_torch.serve.router as router
from repro_torch.core.spmv import SpmvPlan, build_distributed, local_spmv
from repro_torch.serve import MicroBatchConfig, RebalanceConfig, \
    SparseMatrixEngine

from test_torch_host import _to_port

torch.set_num_threads(1)

TOL = 2e-4
BACKENDS = ("numpy", "device")


def _engine(backend, **kw):
    return SparseMatrixEngine(num_shards=4, backend=backend, device="cpu",
                              **kw)


def _scaled_err(A, x, y) -> float:
    absA = dataclasses.replace(A, values=np.abs(A.values))
    return float((np.abs(y - csr_matvec(A, x))
                  / (1.0 + csr_matvec(absA, np.abs(x)))).max())


def _check(backend, A, x, got, want_numpy):
    """numpy: bitwise the reference's answer; device: float32 within the
    scaled tolerance."""
    if backend == "numpy":
        assert got.dtype == np.float64
        assert np.array_equal(got, want_numpy)
    else:
        assert got.dtype == np.float32 and got.shape == want_numpy.shape
        assert _scaled_err(A, x, got) <= TOL


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


def test_spmv_unknown_name_is_actionable_and_uncounted(backend):
    eng = _engine(backend)
    A = make_matrix("ford1", scale=0.05)
    eng.ingest("ford", _to_port(A))
    x = np.zeros(A.ncols)
    with pytest.raises(KeyError, match="ford"):
        eng.spmv("typo", x)
    assert eng.stats()["ford"]["spmv_count"] == 0
    assert set(eng.stats()) == {"ford"}
    eng.spmv("ford", x)
    assert eng.stats()["ford"]["spmv_count"] == 1
    with pytest.raises(KeyError):
        eng.plan("typo")
    with pytest.raises(ValueError, match="elements"):
        eng.spmv("ford", x[:-1])
    assert ("executor" in eng.stats()["ford"]) == (backend == "device")


def test_batched_spmv_bitwise_matches_per_vector(backend):
    """(M, B) blocks equal per-vector calls bitwise, both kernels, on the
    numpy executor (bitwise the reference's) and the device executor."""
    A = make_matrix("cop20k_A", scale=0.005)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((A.ncols, 4))

    def run(dist, x):
        if backend == "numpy":
            return local_spmv(dist, x)
        return t_program.execute(dist, x, backend="device", device="cpu")

    for kernel in ("ell", "seg"):
        fields = dict(kernel=kernel, num_shards=4, reordering="bfs")
        dist = build_distributed(_to_port(A), SpmvPlan(**fields))
        Y = run(dist, X)
        assert Y.shape == (A.nrows, 4)
        for b in range(X.shape[1]):
            assert np.array_equal(Y[:, b], run(dist, X[:, b])), (kernel, b)
        _check(backend, A, X, Y, r_program.execute(
            r_program.lower(A, RPlan(**fields)), X))
    with pytest.raises(ValueError, match="elements"):
        run(dist, X[: A.ncols // 2])
    with pytest.raises(ValueError, match=r"\(N,\) or \(N, B\)"):
        run(dist, X[..., None])


def test_engine_serves_batched_requests(backend):
    eng = _engine(backend)
    ref = r_router.SparseMatrixEngine(num_shards=4)
    A = make_matrix("rmat", scale=0.002)
    eng.ingest("r", _to_port(A))
    ref.ingest("r", A)
    X = np.random.default_rng(1).standard_normal((A.ncols, 3))
    Y = eng.spmv("r", X)
    _check(backend, A, X, Y, ref.spmv("r", X))
    for b in range(3):
        assert np.array_equal(eng.spmv("r", X[:, b]), Y[:, b])


def test_plan_cache_reuses_structural_twins(backend):
    eng = _engine(backend)
    c1 = eng.ingest("m1", _to_port(make_matrix("rmat", scale=0.002, seed=0)))
    assert eng.plan_cache_hits == 0
    A2 = make_matrix("rmat", scale=0.002, seed=7)
    c2 = eng.ingest("m2", _to_port(A2))
    assert eng.plan_cache_hits == 1
    assert eng.stats()["m2"]["plan_cache_hit"]
    assert not eng.stats()["m1"]["plan_cache_hit"]
    assert c2.plan == c1.plan
    assert len(c2.ranking) == 1 and c2.probed == 0
    eng.ingest("banded", _to_port(make_matrix("ford1", scale=0.05)))
    assert eng.plan_cache_hits == 1
    ref = r_router.SparseMatrixEngine(num_shards=4)
    ref.ingest("m1", make_matrix("rmat", scale=0.002, seed=0))
    ref.ingest("m2", A2)
    assert dataclasses.asdict(ref.plan("m2")) == \
        dataclasses.asdict(eng.plan("m2"))
    x = np.random.default_rng(2).standard_normal(A2.ncols)
    _check(backend, A2, x, eng.spmv("m2", x), ref.spmv("m2", x))


def test_plan_cache_can_be_disabled(backend):
    eng = _engine(backend, plan_cache=False)
    eng.ingest("m1", _to_port(make_matrix("rmat", scale=0.002, seed=0)))
    c2 = eng.ingest("m2", _to_port(make_matrix("rmat", scale=0.002, seed=7)))
    assert eng.plan_cache_hits == 0
    assert len(c2.ranking) > 1


def _boom(*a, **k):
    raise AssertionError("warm-start ingest must not reach this path")


def test_warm_start_ingest_skips_autotune_and_lower(backend, tmp_path,
                                                    monkeypatch):
    A = make_matrix("cop20k_A", scale=0.005)
    B = make_matrix("ford1", scale=0.05)
    store = str(tmp_path / "artifacts")
    e1 = _engine(backend, artifact_dir=store)
    c1a = e1.ingest("a", _to_port(A))
    e1.ingest("b", _to_port(B))
    rng = np.random.default_rng(0)
    xa = rng.standard_normal(A.ncols)
    xb = rng.standard_normal(B.ncols)
    ya, yb = e1.spmv("a", xa), e1.spmv("b", xb)
    ref = r_router.SparseMatrixEngine(num_shards=4)
    ref.ingest("a", A)
    _check(backend, A, xa, ya, ref.spmv("a", xa))

    monkeypatch.setattr(router, "autotune", _boom)
    monkeypatch.setattr(router, "lower", _boom)
    e2 = _engine(backend, artifact_dir=store)
    c2a = e2.ingest("a", _to_port(A))
    e2.ingest("b", _to_port(B))
    assert e2.warm_starts == 2
    assert e2.stats()["a"]["warm_start"] and e2.stats()["b"]["warm_start"]
    assert c2a == c1a
    assert np.array_equal(e2.spmv("a", xa), ya)
    assert np.array_equal(e2.spmv("b", xb), yb)


def test_warm_start_digest_mismatch_falls_back_cold(backend, tmp_path):
    from repro_torch.core.sparse_matrix import CSRMatrix
    A = _to_port(make_matrix("rmat", scale=0.002))
    store = str(tmp_path / "artifacts")
    e1 = _engine(backend, artifact_dir=store)
    e1.ingest("a", A)
    A2 = CSRMatrix(shape=A.shape, values=A.values * 2.0,
                   col_index=A.col_index, row_ptr=A.row_ptr)
    e2 = _engine(backend, artifact_dir=store)
    e2.ingest("a", A2)
    assert not e2.stats()["a"]["warm_start"]
    x = np.random.default_rng(1).standard_normal(A.ncols)
    y = e2.spmv("a", x)
    if backend == "numpy":
        np.testing.assert_allclose(y, csr_to_dense(A2) @ x, atol=1e-6)
    else:
        assert _scaled_err(A2, x, y) <= TOL
    e3 = _engine(backend, artifact_dir=store)
    e3.ingest("a", A2)
    assert e3.stats()["a"]["warm_start"]
    assert np.array_equal(e3.spmv("a", x), e2.spmv("a", x))


def test_disk_plan_cache_shared_across_engine_instances(backend, tmp_path):
    cache = str(tmp_path / "plans")
    e1 = _engine(backend, plan_cache_dir=cache)
    c1 = e1.ingest("m1", _to_port(make_matrix("rmat", scale=0.002, seed=0)))
    assert e1.plan_cache_hits == 0
    e2 = _engine(backend, plan_cache_dir=cache)
    c2 = e2.ingest("m2", _to_port(make_matrix("rmat", scale=0.002, seed=7)))
    assert e2.plan_cache_hits == 1
    assert c2.plan == c1.plan
    assert len(c2.ranking) == 1 and c2.probed == 0


def test_per_tenant_rebalance_config_override(backend):
    eng = _engine(backend)
    A = _to_port(make_matrix("rmat", scale=0.002))
    eng.ingest("watched", A, rebalance=RebalanceConfig(window=16))
    eng.ingest("plain", A)
    assert "rebalance" in eng.stats()["watched"]
    assert "rebalance" not in eng.stats()["plain"]
    eng2 = _engine(backend, rebalance=True)
    eng2.ingest("off", A, rebalance=False)
    eng2.ingest("on", A)
    assert "rebalance" not in eng2.stats()["off"]
    assert "rebalance" in eng2.stats()["on"]


def test_micro_batching_gathers_concurrent_requests(backend):
    """Concurrent single-vector requests for one tenant share a batched
    (N, B) call and still return bitwise-solo results."""
    A = make_matrix("cop20k_A", scale=0.005)
    solo = _engine(backend)
    solo.ingest("a", _to_port(A))
    eng = _engine(backend, micro_batch=MicroBatchConfig(max_batch=4,
                                                        max_wait_ms=100.0))
    eng.ingest("a", _to_port(A))
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal(A.ncols) for _ in range(4)]
    want = [solo.spmv("a", x) for x in xs]
    got = [None] * 4
    barrier = threading.Barrier(4)

    def hit(i):
        barrier.wait(timeout=30)
        got[i] = eng.spmv("a", xs[i])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i in range(4):
        assert np.array_equal(got[i], want[i]), i
    mb = eng.stats()["a"]["micro_batch"]
    assert mb["requests"] == 4
    assert mb["widest"] >= 2
    assert eng.stats()["a"]["spmv_count"] == 4
    X = np.stack(xs, axis=1)
    assert np.array_equal(eng.spmv("a", X), np.stack(want, axis=1))
    ref = r_router.SparseMatrixEngine(num_shards=4)
    ref.ingest("a", A)
    _check(backend, A, X, np.stack(got, axis=1), ref.spmv("a", X))


def test_rebalance_swap_rewrites_artifact(backend, tmp_path):
    """After a drift-triggered swap the tenant's bundle holds the new
    program: a restart warm-starts straight into the post-drift plan."""
    cfg = RebalanceConfig(window=32, patience=2, cooldown=2, probe=2)
    A = make_matrix("cop20k_A", scale=0.005)
    N = A.ncols
    store = str(tmp_path / "artifacts")
    eng = _engine(backend, rebalance=cfg, artifact_dir=store)
    eng.ingest("a", _to_port(A))
    m = eng._matrices["a"]
    d = m.dist
    order = np.arange(N) if d.perm is None else d.perm
    hot = np.flatnonzero(d.x_layout.owner_of(order) == 0)
    rng = np.random.default_rng(0)
    k = max(N // 20, 8)
    for _ in range(2 * cfg.window):
        x = np.zeros(N)
        x[rng.integers(0, N, k)] = rng.standard_normal(k)
        eng.spmv("a", x)
    for i in range(10 * cfg.window):
        x = np.zeros(N)
        x[rng.choice(hot, size=k)] = rng.standard_normal(k)
        eng.spmv("a", x)
        if any(e.swapped for e in m.rebalance_log):
            break
    assert any(e.swapped for e in m.rebalance_log), "drift never swapped"
    fresh = _engine(backend, artifact_dir=store)
    fresh.ingest("a", _to_port(A))
    assert fresh.stats()["a"]["warm_start"]
    assert fresh.plan("a") == eng.plan("a")
    x = np.zeros(N)
    x[rng.choice(hot, size=k)] = rng.standard_normal(k)
    assert np.array_equal(fresh.spmv("a", x), eng.spmv("a", x))


def test_reference_bundle_warm_starts_the_port(backend, tmp_path,
                                               monkeypatch):
    """A bundle the reference engine wrote is a warm start for the port:
    no autotune, no lower, the reference's plan and answers."""
    A = make_matrix("cop20k_A", scale=0.005)
    store = str(tmp_path / "artifacts")
    ref = r_router.SparseMatrixEngine(num_shards=4, artifact_dir=store)
    ref_choice = ref.ingest("a", A)
    monkeypatch.setattr(router, "autotune", _boom)
    monkeypatch.setattr(router, "lower", _boom)
    eng = _engine(backend, artifact_dir=store)
    choice = eng.ingest("a", _to_port(A))
    assert eng.stats()["a"]["warm_start"] and eng.warm_starts == 1
    assert choice.to_json() == ref_choice.to_json()
    x = np.random.default_rng(5).standard_normal((A.ncols, 2))
    _check(backend, A, x, eng.spmv("a", x), ref.spmv("a", x))


def test_cuda_engine_raises_without_gpu(monkeypatch):
    """The device backend asked for CUDA where there is none raises when
    the engine is built; nothing serves through numpy quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseMatrixEngine(num_shards=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparseMatrixEngine(num_shards=4, backend="device", device="cuda")
    with pytest.raises(ValueError, match="backend"):
        SparseMatrixEngine(num_shards=4, backend="jax")
    assert SparseMatrixEngine(num_shards=4, backend="numpy").device is None
