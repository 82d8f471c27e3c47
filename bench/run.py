"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints one JSON object as the last line of standard output, and
the numbers compared for ``correct``, each beside its limit, as the last
lines of standard error.  Exits non-zero, with no result, without a card,
when the program is missing, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache of the run at a fixed place in the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "build" / "bench" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchlib import cell

    spec = cell.load_cell(args.workload, ROOT)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cell.log(f"{args.workload} needs {chips} CUDA device(s); {n} found")
        return 2
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), device="cuda", t_start=T_START,
                        root=ROOT)
    found = cell.forbidden_modules()
    if found:
        cell.log(f"modules that no run may load were loaded: {found}")
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
