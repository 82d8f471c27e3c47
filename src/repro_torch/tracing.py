"""Spans and counters of the port: its one place for timing.

A span records its name, its start and end (``time.perf_counter_ns``)
and the span it ran under.  There are two classes:

* **Set-up spans** (:func:`span`) last seconds and occur a few times a
  process: the kernel build, the lowering and its stages, the executor's
  build and each graph capture.  They are always recorded, the last
  :data:`MAX_SPANS` of them kept in memory for :func:`spans`,
  :func:`last`, :func:`children` and :func:`child_seconds`.
* **Per-call spans** (:class:`call_span`) time one call of an executor.
  They are recorded only while :func:`recording` is true: while a
  ``torch.profiler`` session is active, or after :func:`enable`.  They
  are not kept one by one but add to per-name totals (:func:`total`),
  beside the counters of :func:`count` (:func:`counter`).  Totals and
  counters belong to the current recording session, which begins at the
  first call that finds recording on after one that found it off, so a
  reader reads only the run being traced.

While a profiler is active each span is also entered as a profiler range
of the same name, so the program's spans stand on the device trace's own
clock.  The ranges are plain function ranges, not user annotations: the
profiler mirrors no device-side interval for them.

Spans and counters by name (``PERF.md``, "Spans and counters"):
``kernels.build``; ``lower`` over ``lower.reorder``, ``lower.stages``
and ``lower.emu_accounting``; ``executor.build`` over
``executor.operands`` and ``executor.upload``; ``executor.capture``;
the per-call ``spmv.call`` with the counters ``spmv.calls`` and
``spmv.starved`` (calls that found all earlier work of their executor
done, so the device waited for them); and, in an executor with split,
tile or ELL shards, each such family's per-call counters, fixed per x
shape and counted at graph replays too: ``<family>.nnz``,
``<family>.rows``, ``<family>.x_elems`` and ``<family>.y_elems`` (its
shards' nonzeros and rows, the distinct x elements they read and the y
elements they write), ``tile.tiles`` (the tile shards' tiles) and
``split.scratch_bytes`` (the bytes of the split family's running sums,
both passes; its fix-up writes y), and ``split.long_rows``,
``split.long_pieces`` and ``split.long_runs`` (the rows its fix-up takes
on the block's warps, their pieces and their runs, both passes).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

__all__ = ["MAX_SPANS", "Span", "span", "call_span", "recording", "enable",
           "disable", "count", "spans", "last", "children", "child_seconds",
           "total", "counter", "reset"]

#: Set-up spans kept, the oldest dropped first.
MAX_SPANS = 4096

_profiler_enabled = torch._C._autograd._profiler_enabled
_fast_range = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_lock = threading.Lock()
_local = threading.local()
_done: collections.deque = collections.deque(maxlen=MAX_SPANS)
_totals: dict = {}           # per-call span name -> [count, ns]
_counters: dict = {}
_enabled = False
_was_on = False


class Span:
    """A finished (or open: ``end_ns`` None) set-up span."""

    __slots__ = ("name", "parent", "start_ns", "end_ns")

    def __init__(self, name: str, parent: "Span | None"):
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self):
        return f"Span({self.name!r}, {self.start_ns}, {self.end_ns})"


def _range(name: str):
    """The profiler range ``name``, entered, while a profiler is active;
    else None."""
    if not _profiler_enabled():
        return None
    rf = _fast_range(name) if _fast_range is not None \
        else torch.profiler.record_function(name)
    rf.__enter__()
    return rf


@contextlib.contextmanager
def span(name: str):
    """Record the set-up span ``name`` around the block, under the span
    this thread has open; yields the :class:`Span`."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    s = Span(name, stack[-1] if stack else None)
    rf = _range(name)
    stack.append(s)
    s.start_ns = time.perf_counter_ns()
    try:
        yield s
    finally:
        s.end_ns = time.perf_counter_ns()
        stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        _done.append(s)


def recording() -> bool:
    """Whether per-call spans and counters are recorded now: the one check
    an executor call makes when they are not."""
    global _was_on
    if _enabled or _profiler_enabled():
        if not _was_on:
            _begin_session()
        return True
    _was_on = False
    return False


def _begin_session() -> None:
    global _was_on
    with _lock:
        if not _was_on:
            _totals.clear()
            _counters.clear()
            _was_on = True


class call_span:
    """A per-call span: adds its duration to the session's total of
    ``name``.  Enter it only where :func:`recording` is true."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _range(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        with _lock:
            t = _totals.setdefault(self.name, [0, 0])
            t[0] += 1
            t[1] += ns
        if self.rf is not None:       # last: the range covers the span's cost
            self.rf.__exit__(None, None, None)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the session's counter ``name`` (call it only where
    :func:`recording` is true)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Record per-call spans and counters without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record per-call spans and counters only under a profiler again."""
    global _enabled
    _enabled = False


def spans(name: str | None = None) -> list:
    """The kept set-up spans (named ``name``), oldest end first."""
    return [s for s in list(_done) if name is None or s.name == name]


def last(name: str) -> Span | None:
    """The set-up span ``name`` that ended last, or None."""
    for s in reversed(list(_done)):
        if s.name == name:
            return s
    return None


def children(parent: Span, name: str | None = None) -> list:
    """The kept set-up spans directly under ``parent`` (named ``name``)."""
    return [s for s in spans(name) if s.parent is parent]


def child_seconds(parent: str, name: str) -> float | None:
    """Seconds of the spans ``name`` directly under the latest span
    ``parent``, summed; None where either is missing."""
    p = last(parent)
    kids = children(p, name) if p is not None else []
    return sum(s.seconds for s in kids) if kids else None


def total(name: str) -> tuple | None:
    """(count, seconds) of the per-call span ``name`` in the current
    session, or None where it has none."""
    with _lock:
        t = _totals.get(name)
        return None if t is None else (t[0], t[1] / 1e9)


def counter(name: str) -> int:
    """The current session's counter ``name`` (0 where never counted)."""
    with _lock:
        return _counters.get(name, 0)


def reset() -> None:
    """Forget every span, total and counter, and turn :func:`enable` off."""
    global _enabled, _was_on
    with _lock:
        _done.clear()
        _totals.clear()
        _counters.clear()
        _enabled = _was_on = False
