"""A closed loop: one caller calls the graphed executor back to back on
``vectors`` x of ``block`` columns (``block`` 1: (N,) vectors), already
on the device in the program's layout, until the window closes, and
synchronises at its end.  ``sample`` outputs drawn from the seed, and
each x's last one, go to the check."""
import contextlib
import time

import torch

from benchlib import trace, traffic
from benchlib.system import Executor, sync

KEYS = ("vectors", "block", "sample")


def setup(csr, conf, mix, seed, device, prior=None):
    """The executor (``prior``'s, where an earlier cell of the same
    matrix built one), the x, and every kernel loaded and warm."""
    ex = prior["ex"] if prior else Executor(csr, conf["plan"], device)
    N = csr.shape[1]
    xs = [x.cpu().numpy() for x in traffic.vectors(
        N, mix["vectors"], mix["block"], seed=seed, device=device)]
    shards = [ex.x_shards(x) for x in xs]
    ex.run.prime([tuple(shards[0].shape)])
    for s in shards:
        ex.run(s)
    sync(device)
    t0 = time.perf_counter()
    for i in range(8):
        ex.run(shards[i % len(shards)])
    sync(device)
    per_call = (time.perf_counter() - t0) / 8
    return {"ex": ex, "xs": xs, "shards": shards, "per_call": per_call,
            "spans": {"lower_s": ex.lower_s}}


def window(st, mix, seed, seconds, device, tr):
    ex, shards = st["ex"], st["shards"]
    k = len(shards)
    n_est = max(int(seconds / max(st["per_call"], 1e-6)), 1)
    keep = set(traffic.sample(n_est, mix["sample"], seed=seed,
                              stream=3).tolist())
    kept, last = [], [None] * k
    mark = torch.profiler.record_function if tr.active else \
        (lambda _: contextlib.nullcontext())
    run = ex.run
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_end = t0 + trace.TRACE_S if tr.active else float("inf")
    i = traced = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if now >= trace_end:
            tr.stop()
            traced, trace_end = i, float("inf")
            mark = lambda _: contextlib.nullcontext()  # noqa: E731
        j = i % k
        with mark("bench.call"):
            y = run(shards[j])
        last[j] = y
        if i in keep:
            kept.append((j, y))
        i += 1
    sync(device)
    elapsed = time.perf_counter() - t0
    kept += [(j, y) for j, y in enumerate(last) if y is not None]
    return {"calls": i, "traced_calls": traced or i, "elapsed": elapsed,
            "kept": kept, "e2e": {"call_us": elapsed / i * 1e6}}


def counters(st, traced: bool) -> dict:
    """Counters read after the window: in a traced run, the bytes of the
    buffer the exchange builds a call."""
    if not traced:
        return {}
    return {"exchange_bytes": st["ex"].exchange_bytes(st["shards"][0])}


def answers(st, win):
    """(x index, y in the caller's order) of every kept output."""
    return [(j, st["ex"].y_caller(y)) for j, y in win["kept"]]
