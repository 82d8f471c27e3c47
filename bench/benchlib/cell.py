"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``bench/configs/<config>.json`` and the matrix's
generator in ``bench/generators/``, its traffic in
``bench/traffic/<mix>.json`` and the mix's kind in ``bench/kinds/``, each
per-layer metric's reader in ``bench/metrics/<metric>.py``.  Nothing
here names a cell, a configuration, a mix or a metric.  ``run_cell`` is
also the hook the CPU rehearsals call (``device="cpu"``, ``scale`` < 1);
the command itself refuses to run without a card.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import bound, matrices, named, reference, traffic
from .system import REPO, import_program, load_kernels
from .trace import Traced

__all__ = ["FORBIDDEN", "load_cell", "run_cell", "reader",
           "forbidden_modules", "check", "control_error", "log"]

#: Top-level module names no run may have loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*parts) -> None:
    print("bench:", *parts, file=sys.stderr, flush=True)


def load_cell(name: str, root: Path = REPO) -> dict:
    """The cell ``name`` with its configuration, mix and metric entries."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    cell = cells[name]

    def mine(m):
        return name in m.get("workloads", [name])

    bench = named.BENCH
    return {
        "cell": cell,
        "config": json.loads((bench / "configs" / f"{cell['config']}.json")
                             .read_text()),
        "mix": traffic.load(cell["traffic"], bench),
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    """The ``read(ctx)`` of ``bench/metrics/<name>.py``."""
    return named.module("metrics", name).read


def _power_limit(device) -> str | None:
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


# -- the check ----------------------------------------------------------------

def _columns(x) -> torch.Tensor:
    X = torch.from_numpy(np.asarray(x, dtype=np.float64))
    return X[:, None] if X.dim() == 1 else X


def check(csr, xs, answers, device, limit: float, ref=None) -> dict:
    """The largest normwise error of the answers against the float64
    reference, and how many answers are malformed."""
    ref = ref or reference.Reference(csr, device)
    err, bad = 0.0, 0
    for j in sorted({j for j, _ in answers}):
        X = _columns(xs[j])
        want = ref.matmul(X)
        scale = ref.matmul(X, absolute=True)
        for jj, y in answers:
            if jj != j:
                continue
            Y = _columns(y)
            if tuple(Y.shape) != tuple(want.shape):
                bad += 1
                continue
            err = max(err, reference.norm_error(Y, want, scale))
    return {"norm_err": {"value": err, "limit": limit},
            "bad_answers": {"value": bad, "limit": 0}}


def control_error(ref, xs, js) -> float:
    """The control's reading: the reference in bfloat16 in the program's
    place, on the x ``js`` of ``xs``, by the same comparison."""
    err = 0.0
    for j in sorted(set(js)):
        X = _columns(xs[j])
        err = max(err, reference.norm_error(
            ref.matmul(X, dtype=torch.bfloat16), ref.matmul(X),
            ref.matmul(X, absolute=True)))
    return err


# -- the run ------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", scale: float = 1.0, t_start: float | None = None,
             root: Path = REPO) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    import_program()                      # no program, no run: fail first
    spec = load_cell(workload, root)
    conf, mix = spec["config"], spec["mix"]
    kind = traffic.kind(mix["kind"])
    power = _power_limit(device)

    kernels = load_kernels(device)
    if kernels:
        built = kernels["kernel_build_s"]
        log(f"kernels {'built' if built else 'found built'}: build "
            f"{built:.3f} s, load {kernels['kernel_load_s']:.3f} s"
            + (" (this checkout's first, compiling run)" if built else ""))
    t = time.perf_counter()
    csr = matrices.make_matrix(
        conf["matrix"], seed=seed, scale=scale,
        sort_device=device if device.type == "cuda" else None)
    generate_s = time.perf_counter() - t
    log(f"generated {conf['name']}: {csr.shape[0]} rows, {csr.nnz} nnz in "
        f"{generate_s:.3f} s")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    st = kind.setup(csr, conf, mix, seed, device)
    setup_s = time.perf_counter() - t_start
    spans = {**kernels, "generate_s": generate_s, **st["spans"]}
    log(f"set-up {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items()) + ")")

    with Traced(trace, device) as tr:
        win = kind.window(st, mix, seed, seconds, device, tr)
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0

    ctx = {"spans": dict(spans, setup_s=setup_s),
           "counters": {"calls": win["calls"],
                        "traced_calls": win["traced_calls"],
                        **kind.counters(st, trace)},
           "bound": bound.bound_s(csr.shape[0], csr.shape[1], csr.nnz,
                                  _columns(st["xs"][0]).shape[1]),
           "trace": tr.result}

    answers, xs = kind.answers(st, win), st["xs"]
    st.clear()
    del win["kept"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(csr, xs, answers, device, conf["limit"]["norm_err"])
    log(f"reference check {time.perf_counter() - t:.3f} s over "
        f"{len(answers)} answers")

    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(win["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if power:
        dev["power_limit"] = power
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": win["calls"], "failed": win.get("failed", 0),
           "metrics": metrics, "device": dev}
    if trace and tr.result is not None:
        r = tr.result
        if "busy_s" in r:
            dev.update(busy_s=r["busy_s"], window_s=r["window_s"])
            out["breakdown"] = {"device_ops": r["device_ops"],
                                "idle_gaps": r["idle_gaps"]}
    out["checks"] = checks
    return out
