"""The port's spans and counters (``repro_torch.tracing``) on the CPU: the
set-up spans' nesting, the per-call span and counters on and off, their
sessions, the profiler ranges they enter, the timers that read them
(``build_info``, ``graph_stats()``), and the benchmark's readers in a
rehearsal of a cell."""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.core.program as program
from repro_torch import tracing
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data.matrices import make_matrix
from repro_torch.kernels import _lib

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LOWER_KIDS = ("lower.reorder", "lower.stages", "lower.emu_accounting")
BUILD_KIDS = ("executor.operands", "executor.upload")
#: What each reader of the benchmark reads.
SETUP_METRICS = ("reorder_s", "stages_s", "emu_model_s", "operands_s",
                 "upload_s")
CALL_METRICS = ("host_us.call", "starved.call")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def matrix():
    return make_matrix("rmat", scale=0.005, seed=3)


def _executor(A, reordering="random", **kw):
    prog = program.lower(A, SpmvPlan(num_shards=4, kernel="seg",
                                     reordering=reordering))
    run = program.make_program_spmv_fn(prog, device="cpu", **kw)
    x = torch.from_numpy(prog.x_to_device(
        np.ones(A.ncols, dtype=np.float32)))
    return run, x


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def _disjoint(spans):
    s = sorted(spans, key=lambda sp: sp.start_ns)
    return all(a.end_ns <= b.start_ns for a, b in zip(s, s[1:]))


@pytest.mark.parametrize("reordering", ["random", "none"])
def test_setup_spans_nest(matrix, reordering):
    _executor(matrix, reordering)
    lower, build = tracing.last("lower"), tracing.last("executor.build")
    assert lower.parent is None and build.parent is None
    assert lower.end_ns <= build.start_ns
    for parent, names in ((lower, LOWER_KIDS), (build, BUILD_KIDS)):
        kids = tracing.children(parent)
        assert {k.name for k in kids} == set(names)
        assert all(_inside(k, parent) for k in kids)
        assert _disjoint(kids)
        for name in names:                # each once, or summed
            assert tracing.child_seconds(parent.name, name) == \
                pytest.approx(sum(k.seconds for k in kids
                                  if k.name == name))
    # the partition and the stages: one span in ``lower``, one in
    # ``program_from_arrays``
    assert len(tracing.children(lower, "lower.stages")) == 2
    assert tracing.child_seconds("lower", "lower.reorder") > 0
    assert tracing.child_seconds("lower", "no.such.span") is None


def test_program_from_arrays_spans_stand_alone(matrix):
    prog = program.lower(matrix, SpmvPlan(num_shards=4, kernel="seg"))
    tracing.reset()
    program.program_from_arrays(
        shape=prog.matrix.shape, values=prog.matrix.values,
        col_index=prog.matrix.col_index, row_ptr=prog.matrix.row_ptr,
        starts=prog.partition.starts, plan=prog.plan)
    assert [s.name for s in tracing.spans()] == ["lower.stages",
                                                "lower.emu_accounting"]
    assert all(s.parent is None for s in tracing.spans())


def test_calls_off_record_nothing(matrix, monkeypatch):
    run, x = _executor(matrix)
    entered = []
    monkeypatch.setattr(tracing, "call_span",
                        lambda name: entered.append(name))
    monkeypatch.setattr(tracing, "count",
                        lambda name, n=1: entered.append(name))
    monkeypatch.setattr(tracing, "_range", lambda name: entered.append(name))
    for _ in range(5):
        run(x)
    assert not tracing.recording()
    assert entered == []
    assert tracing.total("spmv.call") is None
    assert tracing.counter("spmv.calls") == 0


def _profiled(run, x, n):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            with record_function("bench.call"):
                run(x)
    return prof.profiler.kineto_results.events()


def test_profiler_session_counts_and_ranges(matrix):
    run, x = _executor(matrix)
    n = 7
    events = _profiled(run, x, n)
    count, seconds = tracing.total("spmv.call")
    assert count == n and seconds > 0
    assert tracing.counter("spmv.calls") == n
    assert tracing.counter("spmv.starved") == n      # the CPU: every call
    outer = sorted((e for e in events if e.name() == "bench.call"),
                   key=lambda e: e.start_ns())
    inner = sorted((e for e in events if e.name() == "spmv.call"),
                   key=lambda e: e.start_ns())
    assert len(outer) == len(inner) == n
    for o, i in zip(outer, inner):
        assert o.start_ns() <= i.start_ns() <= i.end_ns() <= o.end_ns()
        assert not i.is_user_annotation()    # no device-side mirror


def test_a_new_session_starts_from_zero(matrix):
    run, x = _executor(matrix)
    _profiled(run, x, 6)
    assert tracing.total("spmv.call")[0] == 6
    run(x)                                    # recording off: ends it
    assert tracing.total("spmv.call")[0] == 6  # readable after the run
    _profiled(run, x, 3)
    assert tracing.total("spmv.call")[0] == 3
    assert tracing.counter("spmv.calls") == 3


def test_enable_records_without_a_profiler(matrix):
    run, x = _executor(matrix)
    tracing.enable()
    for _ in range(4):
        run(x)
    assert tracing.total("spmv.call")[0] == 4
    tracing.disable()
    run(x)
    assert not tracing.recording()
    tracing.enable()
    run(x)
    assert tracing.total("spmv.call")[0] == 1


def test_setup_spans_enter_profiler_ranges(matrix):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _executor(matrix)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"lower", "executor.build", *LOWER_KIDS, *BUILD_KIDS} <= names


def test_counters_lose_no_update_across_threads():
    tracing.enable()
    per, workers = 300, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                assert tracing.recording()
                with tracing.call_span("t.call"):
                    tracing.count("t.calls")
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tracing.total("t.call")[0] == per * workers
    assert tracing.counter("t.calls") == per * workers


def test_spans_nest_per_thread():
    got = {}

    def other():
        with tracing.span("other") as s:
            got["s"] = s
    with tracing.span("outer") as outer:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        with tracing.span("inner") as inner:
            pass
    assert inner.parent is outer and got["s"].parent is None


# -- the timers that read the spans ---------------------------------------------

def test_build_info_reads_the_build_span(tmp_path, monkeypatch):
    """A stand-in compiler that writes its ``-o`` target: the build's
    seconds are the span ``kernels.build``'s, and its keys stay."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(_lib, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_lib, "build_info", {})
    out = _lib.build()
    assert out.read_text() == "built\n"
    span = tracing.last("kernels.build")
    assert set(_lib.build_info) == {"seconds", "ptxas"}
    assert _lib.build_info["seconds"] == span.seconds > 0
    _lib.build_info.clear()
    _lib.build()                              # found built: no span
    assert _lib.build_info == {"seconds": 0.0}
    assert tracing.spans("kernels.build") == [span]


class _Event:
    pending = False

    def query(self):
        return not _Event.pending


class _Stream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass

    def record_event(self):
        return _Event()


class _Graph:
    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


def _fake_cuda(monkeypatch):
    """Enough of ``torch.cuda`` for the graphed executor's control flow on
    the CPU: streams, events (pending while ``_Event.pending``), graphs
    whose replay does nothing."""
    stream = _Stream()
    for name, value in (("Stream", lambda dev: _Stream()),
                        ("CUDAGraph", _Graph),
                        ("stream", lambda s: torch.no_grad()),
                        ("current_stream", lambda dev: stream),
                        ("memory_reserved", lambda dev: 0)):
        monkeypatch.setattr(torch.cuda, name, value)


def test_graphed_call_spans_and_starvation(monkeypatch):
    _fake_cuda(monkeypatch)
    S, per = 4, 8
    run = program._graphed(lambda x: x * 2, torch.device("cpu"), S, per)
    x = torch.ones(S, per)
    run(x)                                    # off: captures, counts nothing
    assert tracing.counter("spmv.calls") == 0
    capture = tracing.last("executor.capture")
    stats = run.graph_stats()
    assert [set(st) for st in stats] == [{"shape", "capture_s", "bytes",
                                          "replays"}]
    assert stats[0]["capture_s"] == capture.seconds
    tracing.enable()
    _Event.pending = True                     # the device is still busy
    try:
        for _ in range(3):
            run(x)
    finally:
        _Event.pending = False
    run(x)                                    # finds the device idle
    assert tracing.total("spmv.call")[0] == 4
    assert tracing.counter("spmv.calls") == 4
    assert tracing.counter("spmv.starved") == 1
    assert run.graph_stats()[0]["replays"] == 5
    assert len(tracing.spans("executor.capture")) == 1


# -- the benchmark's readers ------------------------------------------------------

def test_benchmark_rehearsal_reads_every_span():
    sys.path.insert(0, str(REPO / "bench"))
    try:
        from benchlib import cell
        out = cell.run_cell("rmat.solve", 2**31 + 4321, 0.3, True,
                            device="cpu", scale=0.02, root=REPO)
    finally:
        sys.path.remove(str(REPO / "bench"))
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True
    for name in SETUP_METRICS + CALL_METRICS:
        assert m[name] > 0, name
    assert m["starved.call"] == 100.0          # the CPU: every call
    assert sum(m[k] for k in SETUP_METRICS) <= m["lower_s"]
    assert out["metrics"]["host_us.call"]["unit"] == "us"
