#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s executor phases and ``kernel_api`` cases alone
on one GPU.

    python3 tools/smoke_cases.py                           # every case
    python3 tools/smoke_cases.py blocked_band api/tile      # only these
    python3 tools/smoke_cases.py --root OTHER api/tile     # another tree's

Builds the phases' matrices as ``chip_smoke.py`` does, then runs each
named executor phase (cop20k_A/seg, cop20k_A/ell, blocked_band,
powerlaw_tail; the cop20k_A plan is ``chip_smoke.COP20K_PLAN``, the
autotuner's pick) through ``chip_smoke.run_program`` and each named
``kernel_api`` case through ``chip_smoke.run_api_call``, both from the
tree under ``--root`` (default: this one), with its port: the same
checks (scaled error, reruns and columns bitwise, each kernel against its
plain version) and timings.  Only those entry points are used, so an
older tree runs too: to compare two trees, run this once per tree,
alternating, in one call.

Prints the card's name and power limit, then one JSON line a case: its
call ms and, for each kernel it launched, the graph-replayed ms of its
launches for a vector and an (N, 8) block, their bounds, the plain
version's and the library call's ms.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def summary(label, root, r) -> dict:
    out = dict(case=label, tree=str(root), max_scaled_err=r["max_scaled_err"])
    for key in ("call_ms", "block8_ms", "spmv_graph_ms", "block8_graph_ms"):
        if key in r:
            out[key] = r[key]
    for name, s in r["kernels"].items():
        s8 = r["kernels_b8"][name]
        out[name] = dict(ms=s["ms"], ms_b8=s8["ms"], bound_ms=s["bound_ms"],
                         bound_ms_b8=s8["bound_ms"], plain_ms=s["plain_ms"],
                         library_ms=s["library_ms"], launches=s["launches"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the tree whose chip_smoke.py and port to run")
    ap.add_argument("cases", nargs="*", help="case labels (default: all)")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("smoke_cases: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)

    def wanted(label):
        return not args.cases or label in args.cases

    rng = np.random.default_rng(0)

    def inputs(A):
        return ([rng.standard_normal(A.ncols) for _ in range(4)],
                rng.standard_normal((A.ncols, 8)))

    matrices = {}
    for label, build, plans in cs.phases():
        A = matrices[label] = build()
        for plan_label, plan in plans:
            if wanted(plan_label):
                r = cs.run_program(torch, plan_label, A, plan, *inputs(A),
                                   dev)
                print(json.dumps(summary(plan_label, root, r)), flush=True)
    warnings.filterwarnings("ignore", message="bell_",
                            category=DeprecationWarning)
    for label, A, call in cs.api_cases(torch, matrices, dev):
        if wanted(label):
            r = cs.run_api_call(torch, label, A, call, *inputs(A), dev)
            print(json.dumps(summary(label, root, r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
