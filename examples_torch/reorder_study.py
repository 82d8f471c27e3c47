"""The paper's headline table on the port: reordering gains on the Emu
model vs a real cache-hierarchy CPU (Figs. 10 & 12 side by side).

Host only.  The Emu columns are the port's numpy copy of the model,
bitwise ``examples/reorder_study.py``'s; the "this CPU" columns are wall
clock SpMV bandwidth of the machine running it.

    PYTHONPATH=src python examples_torch/reorder_study.py
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.cache_model import measure_cpu_spmv
from repro_torch.core.emu import EmuConfig, run_spmv
from repro_torch.core.layout import make_layout
from repro_torch.core.partition import make_partition
from repro_torch.core.reorder import reorder
from repro_torch.data.matrices import make_matrix


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    A_emu = make_matrix("cop20k_A", scale=0.02)
    A_cpu = make_matrix("cop20k_A", scale=0.3)
    print(f"{'reordering':10s} {'Emu model MB/s':>14s} {'gain':>6s}"
          f" {'this CPU MB/s':>14s} {'gain':>6s}")
    base_e = base_c = None
    rows = []
    for r in ("none", "random", "bfs", "metis"):
        Be, Bc = reorder(A_emu, r), reorder(A_cpu, r)
        e = run_spmv(Be, make_partition(Be, 8, "nonzero"),
                     make_layout("block", Be.ncols, 8), EmuConfig())
        c = measure_cpu_spmv(Bc, trials=5)
        base_e = base_e or e.bandwidth_mbs
        base_c = base_c or c.bandwidth_mbs
        print(f"{r:10s} {e.bandwidth_mbs:14.1f} {e.bandwidth_mbs/base_e:6.2f}"
              f" {c.bandwidth_mbs:14.1f} {c.bandwidth_mbs/base_c:6.2f}")
        rows.append(dict(reordering=r, emu_mbs=e.bandwidth_mbs,
                         emu_gain=e.bandwidth_mbs / base_e,
                         cpu_mbs=c.bandwidth_mbs,
                         cpu_gain=c.bandwidth_mbs / base_c))
    print("\npaper: reordering is worth far more on the migratory machine")
    print("(<=1.7x) than on the cache machine (<=1.16x), and random only")
    print("helps on the migratory machine.")
    return {"rows": rows}


if __name__ == "__main__":
    main()
