"""The readings a configuration's correctness limit is set from.

    python3 bench/control.py --config <name> --seconds <s> --seeds <n> ...

For every seed, in one process: the configuration's matrix, then each of
its cells in ``BENCHMARK.json`` through the timed path for a short window
at the cell's own size and load (cells of one kind hand their state to
the next, so the closed-loop cells share one executor), then the program's reading (the normwise error of the answers
it produced, as a run compares them) and the control's (the reference in
bfloat16 in the program's place, on the same x).  Prints one JSON line a
seed and cell, and one a seed with the Emu model's traffic measures of
the lowered partition.  The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _traffic_line(config, seed, st) -> None:
    """The Emu model's traffic measures of the lowered program's partition
    (a description of the configuration, not a card metric)."""
    t = st["ex"].program.traffic
    print(json.dumps({"config": config, "seed": seed, "traffic": {
        "migrations": int(t.migrations),
        "remote_x_loads": int(t.remote_x_loads),
        "mem_instr_cv": float(t.mem_instr_cv),
        "inbound_cv": float(t.inbound_cv),
        "hotspot_share": float(t.hotspot_share)}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch
    from benchlib import cell, matrices, reference, traffic
    from benchlib.system import load_kernels
    from benchlib.trace import Traced

    device = torch.device(args.device)
    root = cell.REPO
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = [cell.load_cell(w["name"], root) for w in spec["workloads"]
             if w["config"] == args.config]
    conf = cells[0]["config"]
    load_kernels(device)
    for seed in args.seeds:
        csr = matrices.make_matrix(
            conf["matrix"], seed=seed, scale=args.scale,
            sort_device=device if device.type == "cuda" else None)
        results, prior = [], {}
        for c in cells:
            mix = c["mix"]
            kind = traffic.kind(mix["kind"])
            st = kind.setup(csr, conf, mix, seed, device,
                            prior=prior.get(mix["kind"]))
            win = kind.window(st, mix, seed, args.seconds, device,
                              Traced(False, device))
            if len(results) == 0:
                _traffic_line(args.config, seed, st)
            results.append((c["cell"]["name"], st["xs"],
                            kind.answers(st, win), win.get("failed", 0)))
            prior[mix["kind"]] = st
        prior.clear()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference.Reference(csr, device)
        for name, xs, answers, failed in results:
            got = cell.check(csr, xs, answers, device,
                              conf["limit"]["norm_err"], ref=ref)
            ctrl = cell.control_error(ref, xs, [j for j, _ in answers])
            print(json.dumps({
                "config": args.config, "cell": name, "seed": seed,
                "nnz": csr.nnz, "answers": len(answers), "failed": failed,
                "program": got["norm_err"]["value"],
                "bad_answers": got["bad_answers"]["value"],
                "control": ctrl, "limit": conf["limit"]["norm_err"]}),
                flush=True)
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
