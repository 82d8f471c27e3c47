"""The traced window: ``torch.profiler`` around it, reduced to what the
per-layer metrics read.

``Traced`` profiles the host (CPU ops and the benchmark's own
``record_function`` spans) and, on a card, the device (kernels, copies,
sets).  ``reduce`` turns the events into:

* ``busy_s``: the union of the device operations' intervals (the
  benchmark's own spans, which the profiler mirrors on the device's
  timeline, are not operations);
* ``device_op_s``: their summed durations, and ``device_ops``, the ten
  names that took most of it;
* ``idle_gaps``: the device's idle time between operations, summed by
  what the host was doing then (the innermost host event running at each
  gap's middle), the ten names with most;
* ``window_s``: the traced window's length on the host clock.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["TRACE_S", "Traced", "reduce_events"]

#: Seconds of a closed loop's window that a traced run profiles.
TRACE_S = 10.0
#: Host events, latest started first, searched for the one under a gap.
COVER_SCAN = 256


def _ns(ev, what: str) -> int:
    get = getattr(ev, what + "_ns", None)
    return int(get()) if get is not None else int(getattr(ev, what + "_us")()
                                                   * 1000)


def short_name(name: str) -> str:
    """A kernel's name without its signature, and without its template
    arguments where they run long (ATen's kernels)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0].strip() or name
    if len(name) > 80:
        name = name.split("<", 1)[0]
    return name


def _annotation(ev) -> bool:
    """A ``record_function`` span mirrored on the device's timeline: it
    spans the kernels under it, and is no device operation itself."""
    marked = getattr(ev, "is_user_annotation", None)
    return (marked is not None and marked()) or ev.name().startswith("bench.")


class Traced:
    """Context manager: profiles from its entry until ``stop()`` (or its
    exit) when ``enabled``; ``result`` then holds the reduction (None
    when not enabled).  A closed loop stops it after ``TRACE_S`` seconds
    of its window, so that reading the trace stays short whatever the
    run's length."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.result = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    @property
    def active(self) -> bool:
        return self._prof is not None

    def stop(self, exc=(None, None, None)) -> None:
        """End the traced window: wait for the device, stop the profiler
        and reduce its events."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce_events(prof.profiler.kineto_results.events(),
                                        window_s)

    def __exit__(self, *exc):
        self.stop(exc)
        return False


def reduce_events(events, window_s: float) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in events:
        rec = (ev.name(), _ns(ev, "start"), _ns(ev, "duration"))
        if ev.device_type() != cuda:
            host.append(rec)
        elif not _annotation(ev):
            dev.append(rec)
    out = {"window_s": window_s, "device_events": len(dev)}
    if not dev:
        return out
    names = np.array([d[0] for d in dev], dtype=object)
    start = np.array([d[1] for d in dev], dtype=np.int64)
    dur = np.array([d[2] for d in dev], dtype=np.int64)
    by_name: dict = {}
    for n, d in zip(names, dur):
        n = short_name(n)
        by_name[n] = by_name.get(n, 0) + int(d)
    out["device_op_s"] = float(dur.sum()) / 1e9
    out["device_ops"] = [[n, s / 1e9] for n, s in
                         sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    order = np.argsort(start, kind="stable")
    s, e = start[order], start[order] + dur[order]
    reach = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > reach[:-1]])
    us, ue = s[new], np.maximum.reduceat(e, np.flatnonzero(new))
    out["busy_s"] = float((ue - us).sum()) / 1e9
    gap_start, gap_len = ue[:-1], us[1:] - ue[:-1]
    out["idle_gaps"] = _named_gaps(gap_start, gap_len, host)
    return out


def _named_gaps(gap_start, gap_len, host) -> list:
    """The device's idle time by the host event under each gap: the one
    that started last before the gap's middle and still ran then (the
    innermost, of the ``COVER_SCAN`` that started last)."""
    if not len(gap_len):
        return []
    mid = gap_start + gap_len // 2
    names = np.full(len(mid), "host: no traced op", dtype=object)
    if host:
        order = np.argsort([h[1] for h in host], kind="stable")
        h_name = np.array([host[i][0] for i in order], dtype=object)
        h_start = np.array([host[i][1] for i in order], dtype=np.int64)
        h_end = h_start + np.array([host[i][2] for i in order],
                                   dtype=np.int64)
        pos = np.searchsorted(h_start, mid, side="right") - 1
        found = np.zeros(len(mid), dtype=bool)
        for k in range(COVER_SCAN):
            idx = pos - k
            ok = ~found & (idx >= 0)
            ok[ok] &= h_end[idx[ok]] >= mid[ok]
            names[ok] = h_name[idx[ok]]
            found |= ok
    by_name: dict = {}
    for n, g in zip(names, gap_len):
        by_name[n] = by_name.get(n, 0) + int(g)
    return [[n, s / 1e9] for n, s in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
