#!/usr/bin/env python3
"""Time the executor alone, per phase of ``chip_smoke.py``, on one GPU.

    python3 tools/executor_times.py                       # this tree's port
    python3 tools/executor_times.py --src OTHER/src       # another tree's

Lowers each executor phase of ``chip_smoke.py`` (cop20k_A/seg,
cop20k_A/ell, blocked_band, powerlaw_tail) with the port found under
``--src`` (default: this tree's ``src``), then times one call of the
executor (``make_program_spmv_fn``) on a single vector and on an (N, 8)
block, each eager (CUDA events around 10 back-to-back calls) and replayed
as a captured CUDA graph, ``REPEATS`` times in turn.  No kernel is
replayed on its own and nothing else is timed, so these times do not
depend on what ``chip_smoke.py`` ran before a phase.  Only the
executor's entry points are used, so an older tree's port runs too: to
compare two trees, run this once per tree, alternating, in one call.

Prints the card's name and power limit, then one JSON line per phase
with every repeat's times (ms) and a SHA-256 digest of the bytes of the
vector's and the block's outputs (``y_sha256``, ``block8_sha256``: the
inputs come from a fixed seed, so equal digests across trees mean
bitwise-equal outputs).  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPEATS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory holding the repro_torch to time")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("executor_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    # chip_smoke put this tree's src first; the port under --src goes
    # before it
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.core import program as P

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for _, build, plans in cs.phases():
        A = build()
        x1 = rng.standard_normal(A.ncols)
        x8 = rng.standard_normal((A.ncols, 8))
        for label, plan in plans:
            prog = P.lower(A, plan)
            fn = P.make_program_spmv_fn(prog, device=dev)

            def on_card(x, prog=prog):
                if prog.perm is not None:
                    x = P._apply_perm(x, prog.perm)
                return torch.from_numpy(
                    prog.x_to_device(x.astype(np.float32))).to(dev)

            xs1, xs8 = on_card(x1), on_card(x8)
            timers = {"eager_ms": (cs.cuda_ms, xs1),
                      "block8_ms": (cs.cuda_ms, xs8),
                      "graph_ms": (cs.graph_ms, xs1),
                      "block8_graph_ms": (cs.graph_ms, xs8)}
            times = {kind: [] for kind in timers}
            for _ in range(REPEATS):
                for kind, (timer, xs) in timers.items():
                    times[kind].append(timer(torch, lambda xs=xs: fn(xs), 10))
            digests = {kind: hashlib.sha256(
                fn(xs).cpu().numpy().tobytes()).hexdigest()[:16]
                for kind, xs in (("y_sha256", xs1), ("block8_sha256", xs8))}
            print(json.dumps({"phase": label, "port": P.__file__, **times,
                              **digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
