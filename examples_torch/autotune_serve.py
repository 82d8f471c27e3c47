"""Autotuned SpMV serving on the port.

Ingest structurally different matrices (including a mixed-structure one)
into the port's sparse serving engine; each gets its own cost-model-tuned
plan at load time, a kernel *per shard*, and is served on the device by
the graph-replayed executor (the port's SpMV kernels on a GPU).  Serve
y = A @ x requests and print which plan each matrix ended up with, shard
by shard (plus the cost oracle's bottleneck class), and why it differs.
Ends with the oracle's amortization gate deciding the *same* drift
re-plan both ways: the busy tenant's projected volume pays it back, the
idle tenant's never does.

The plan columns are ``examples/autotune_serve.py``'s (the port's
planner is bitwise the reference's).  The last column differs: the port
serves in float32, so it prints the |A|·|x|-scaled error of each answer
against the float64 ``csr_matvec``, max |y - A x| / (1 + |A| |x|), whose
gate is 2e-4; the reference's ``allclose(..., atol=1e-6)`` fits its
float64 host executor only.

    PYTHONPATH=src python examples_torch/autotune_serve.py --device cuda
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.oracle import DEFAULT_ORACLE
from repro_torch.core.sparse_matrix import csr_matvec
from repro_torch.data.matrices import make_matrix, mixed_structure
from repro_torch.kernels.ops import resolve_device
from repro_torch.serve.engine import SparseMatrixEngine

#: The port's end-to-end gate on a served answer (float32 on the device).
SCALED_TOL = 2e-4


def _shards_str(kernels) -> str:
    """Compress ('ell','ell','seg',...) to 'ell x2 + seg x6' style."""
    runs = []
    for k in kernels:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return " + ".join(f"{k}x{n}" if n > 1 else k for k, n in runs)


def scaled_error(A, x, y) -> float:
    """max |y - A x| / (1 + |A| |x|), A x in float64."""
    absA = dataclasses.replace(A, values=np.abs(A.values))
    return float((np.abs(y - csr_matvec(A, x))
                  / (1.0 + csr_matvec(absA, np.abs(x)))).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # probe="auto" spends Emu probes adaptively at ingest (see the
    # reference example).
    eng = SparseMatrixEngine(num_shards=8, probe="auto", device=device)
    rng = np.random.default_rng(0)
    mats = {name: make_matrix(name, scale=scale)
            for name, scale in (("cop20k_A", 0.02), ("webbase-1M", 0.002),
                                ("audikw_1", 0.001))}
    # Same mixed-structure workload as benchmarks/hetero_bench.py: at this
    # size the locality-rich bases keep the analytic-vs-measured inversion
    # rate unstable, so probe="auto" keeps spending until it measures
    # them — and lands on a per-shard heterogeneous program.
    mats["mixed"] = mixed_structure(4096, 33 * 4096)

    print(f"{'matrix':12s} {'chosen plan':26s} {'per-shard kernels':24s} "
          f"{'bottleneck':>10s} {'migrations':>10s} {'hot-share':>9s} "
          f"{'scaled-err<=2e-4':>16s}")
    tenants = {}
    for name, A in mats.items():
        eng.ingest(name, A)                       # autotunes here
        x = rng.standard_normal(A.ncols)
        y = eng.spmv(name, x)
        err = scaled_error(A, x, y)
        s = eng.stats()[name]
        p = s["plan"]
        plan = f"{p['reordering']}/{p['layout']}/{p['distribution']}"
        print(f"{name:12s} {plan:26s} {_shards_str(s['shard_kernels']):24s} "
              f"{s['bottleneck']:>10s} {s['migrations']:10d} "
              f"{s['hotspot_share']:9.3f} {err:16.2e}")
        tenants[name] = dict(plan=plan, shard_kernels=list(s["shard_kernels"]),
                             bottleneck=s["bottleneck"],
                             migrations=int(s["migrations"]),
                             hotspot_share=s["hotspot_share"],
                             scaled_error=err, ok=err <= SCALED_TOL)

    print("\nhot-spot FEM -> reordered; power-law -> nonzero split; "
          "wide-band -> plain block; mixed structure -> a different kernel "
          "per shard. The study, applied as policy — per nodelet.")

    # -- the amortization gate, on a busy vs an idle tenant ----------------
    # Skew the traffic: cop20k_A absorbs nearly all requests, audikw_1
    # almost none; then put the same drift re-plan (a modeled 8%
    # per-SpMV win, full-tier swap) in front of the oracle's gate, each
    # tenant's horizon its traffic share of the next `lookahead` requests.
    x = rng.standard_normal(mats["cop20k_A"].ncols)
    for _ in range(58):
        eng.spmv("cop20k_A", x)
    gain, lookahead = 0.08, 500
    print(f"\nsame drift re-plan (modeled gain {gain:.0%}, full swap "
          f"~{DEFAULT_ORACLE.replan_pays(gain, None).break_even_spmvs:.0f} "
          f"SpMVs to break even), lookahead {lookahead} engine requests:")
    gate = {}
    for name in ("cop20k_A", "audikw_1"):
        share = eng.stats()[name]["spmv_count"] / eng.total_requests
        d = DEFAULT_ORACLE.replan_pays(gain, horizon=lookahead * share)
        verdict = "re-plan PAYS" if d.pays else "re-plan REFUSED"
        print(f"  {name:12s} share {share:5.1%} -> horizon "
              f"{d.horizon:5.1f} SpMVs: {verdict}")
        gate[name] = dict(share=share, horizon=d.horizon, pays=d.pays)
    print("volume-blind gating would have taken both; the oracle spends "
          "the one-time swap only where the traffic pays it back.")
    return {"tenants": tenants, "gate": gate}


if __name__ == "__main__":
    main()
