#!/usr/bin/env python3
"""Where a call of the SpMV executor over a mesh spends its time on the
card, against the one-device executor.

    python3 tools/mesh_profile.py [labels ...]

Lowers the programs of ``chip_smoke.py``'s ``spmv_mesh`` phase
(``MESH_CASES``, or the labels given) at their full size, brings up a
world-size-1 NCCL group and a ("model",) mesh over it, and for each
program and x width (a vector, an (N, 8) block) times, by CUDA events
around each call alone (medians of ``chip_smoke.MESH_ITERS``, the calls
taking turns): the whole eager call of the one-device and the mesh
executor (pipelined); their exchanges alone (``run.buffers``: the local
buffer and the exchange buffer); and the mesh exchange's bare collective
on buffers of its shapes.  Then one call of each executor runs under
``torch.profiler``: device ms by kernel (the top 12), their sum and the
call's wall ms.  Prints the card's name and power limit, then one JSON
line a program.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def profiled(torch, fn) -> dict:
    """One call of ``fn`` under the profiler: device ms by kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = e.cuda_time_total
        if dt and getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (dt / 1e3, e.count)
    return dict(wall_ms=wall_ms,
                kernel_ms=sum(ms for ms, _ in kernels.values()),
                launches=sum(n for _, n in kernels.values()),
                top=[{"kernel": k[:100], "ms": v[0], "launches": v[1]}
                     for k, v in sorted(kernels.items(),
                                        key=lambda kv: -kv[1][0])[:12]])


def bare_collective(torch, dist, group, prog, ops, B, dev):
    """The mesh exchange's collective alone, on buffers of its shapes."""
    from repro_torch.core import program as P
    S = prog.plan.num_shards
    per = prog.x_layout.padded_length() // S
    if "halo" in prog.plan.resolved_shard_exchanges():
        send = torch.zeros((S, S, ops["halo_H"], B), device=dev)
        recv = torch.empty_like(send)
        return lambda: dist.all_to_all_single(recv, send, group=group)
    xb = torch.zeros((S, per, B), device=dev)
    out = torch.empty_like(xb)
    return lambda: P._all_gather(out, xb, group)


def main(argv=None) -> int:
    labels = (argv if argv is not None else sys.argv[1:])
    import torch
    if not torch.cuda.is_available():
        print("mesh_profile: CUDA is not available", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.core import program as P
    from repro_torch.launch.mesh import build_mesh, world_devices

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    labels = labels or list(cs.MESH_CASES)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = build_mesh(("model",), (1,), world_devices(dev))
            group = mesh.group(("model",))
            for label, build, plans in cs.phases():
                wanted = [(pl, plan) for pl, plan in plans if pl in labels]
                A = build() if wanted else None
                for pl, plan in wanted:
                    prog = P.lower(A, plan)
                    ops = P._device_operands(prog)
                    one = P.make_program_spmv_fn(prog, device=dev)
                    run = P.make_program_spmv_fn(prog, mesh)
                    out = {"case": pl}
                    for B in (1, 8):
                        shape = (A.ncols,) if B == 1 else (A.ncols, B)
                        xp = rng.standard_normal(shape).astype(np.float32)
                        xs = torch.from_numpy(prog.x_to_device(xp)).to(dev)
                        ms = cs.median_ms(torch, [
                            lambda: one(xs), lambda: run(xs),
                            lambda: one.buffers(xs), lambda: run.buffers(xs),
                            bare_collective(torch, dist, group, prog, ops, B,
                                            dev)])
                        out[f"B{B}"] = dict(
                            one_device_ms=ms[0], mesh_ms=ms[1],
                            one_device_exchange_ms=ms[2],
                            mesh_exchange_ms=ms[3], collective_ms=ms[4],
                            one_device_profile=profiled(torch,
                                                        lambda: one(xs)),
                            mesh_profile=profiled(torch, lambda: run(xs)))
                    print(json.dumps(out), flush=True)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
