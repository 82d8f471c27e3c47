#!/usr/bin/env python3
"""Where one LM train step's time goes on the card.

    python3 tools/train_profile.py [--arch qwen3_4b] [--batch 4] [--seq 512]

Builds the arch at its published size from a seeded CUDA generator with
AdamW state on top (as ``chip_smoke.py``'s ``lm_train`` phase does),
takes two warm-up steps through ``make_train_step`` (remat on,
grad_accum 1), then times under CUDA events, three times each: the
gradients alone (forward, the recompute of remat and backward, the calls
``make_train_step`` makes), ``apply_updates`` alone on them, and whole
steps.  One more step runs under ``torch.profiler``: device time by
kernel (the top 25), summed by family (GEMM, elementwise, reduction,
copy and index, other), and the share of the step's wall time the card
spent in kernels.  Prints the card's name and power limit, then one JSON
line.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

FAMILIES = (("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
            ("reduction", ("reduce", "norm_kernel", "softmax", "logsumexp",
                           "cumsum", "scan")),
            ("copy_index", ("copy", "cat", "index", "gather", "scatter",
                            "fill", "unbind", "stack", "embedding")),
            ("elementwise", ("elementwise", "pointwise", "launch_clamp")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def events_ms(torch, fn, reps: int = 3) -> list:
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("train_profile: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import DataConfig, TokenStream
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as mm
    from repro_torch.models import params as pp
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = pp.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    opt = adamw.init_state(params)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)
    run = loop.RunConfig(fsdp=False, remat=True)
    step_fn, _, _ = loop.make_train_step(
        cfg, opt_cfg, Mesh(("data", "model"), (1, 1), (dev,)), run)
    stream = TokenStream(cfg, DataConfig(seed=args.seed, batch=args.batch,
                                         seq_len=args.seq))
    batch = loop.to_device(stream.batch_at(0), dev)
    state = {"params": params, "opt": opt}

    def step():
        state["params"], state["opt"], _ = step_fn(state["params"],
                                                   state["opt"], batch)

    def grads():
        state.pop("grads", None)
        live = pp.tree_map(lambda p: p.detach().requires_grad_(),
                           state["params"])
        loss, _ = mm.loss_fn(live, cfg, batch, remat=True)
        state["grads"] = pp.tree_unflatten(live, torch.autograd.grad(
            loss, pp.tree_leaves(live)))

    def update():
        adamw.apply_updates(state["params"], state["grads"], state["opt"],
                            opt_cfg)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "batch": args.batch, "seq": args.seq,
           "grads_ms": events_ms(torch, grads)}
    out["apply_updates_ms"] = events_ms(torch, update)
    del state["grads"]
    out["step_ms"] = events_ms(torch, step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
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
    busy = sum(ms for ms, _ in kernels.values())
    fams = {}
    for name, (ms, n) in kernels.items():
        f = fams.setdefault(family(name), [0.0, 0])
        f[0] += ms
        f[1] += n
    out.update(
        profiled_wall_ms=wall_ms, kernel_ms=busy,
        busy_share=busy / wall_ms, kernel_launches=sum(
            n for _, n in kernels.values()),
        families={k: {"ms": v[0], "launches": v[1]}
                  for k, v in sorted(fams.items(), key=lambda kv: -kv[1][0])},
        top=[{"kernel": k[:120], "ms": v[0], "launches": v[1]}
             for k, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])
             [:25]])
    for key in ("grads_ms", "apply_updates_ms", "step_ms"):
        out[key.replace("_ms", "_median_ms")] = float(np.median(out[key]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
