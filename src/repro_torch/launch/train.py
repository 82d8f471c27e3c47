"""Training launcher: the token stream through ``train_loop`` on the host
mesh, with checkpoints and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --smoke --steps 4 --device cpu     # reduced config, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --smoke --steps 100 --resume       # on CUDA, from the last checkpoint
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
        repro_torch.launch.train --arch qwen3_4b --smoke --steps 4

Under ``torchrun`` each rank brings up the process group (NCCL on CUDA,
gloo with ``--device cpu``), the mesh spans the world ((n/2, 2) on
("data", "model") for an even n), and rank 0 prints and writes the
checkpoints.  As in the reference the launcher trains without FSDP and
at ``--grad-accum`` 2.  Random initial weights from a generator seeded
with 0 (the repo holds no checkpoint of a published model).  Runs on
CUDA unless ``--device cpu`` is given; the default checkpoint directory
lies under the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="straggler deadline per step (0 = off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.synthetic import DataConfig, TokenStream
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt, elastic
    from repro_torch.train.loop import RunConfig, train_loop

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    started = not dist.is_initialized() and init_distributed(args.device)
    mesh = make_host_mesh(device=args.device)
    lead = not mesh.distributed or dist.get_rank() == 0
    run = RunConfig(fsdp=False, remat=True, donate=True,
                    grad_accum=args.grad_accum,
                    step_deadline_s=args.deadline_s)
    stream = TokenStream(cfg, DataConfig(seed=0, batch=args.batch,
                                         seq_len=args.seq))
    opt_cfg = adamw.AdamWConfig(total_steps=args.steps)

    params = opt_state = None
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt) is not None:
        params, opt_state, start = elastic.resume(cfg, opt_cfg, args.ckpt,
                                                  mesh, run)
        if lead:
            print(f"resumed from step {start}")

    def report(step, m):
        if lead and step % 10 == 0:
            extra = " STRAGGLER" if "straggler" in m else ""
            print(f"step {step:5d} loss={m['loss']:.4f} lr={m['lr']:.2e}"
                  f"{extra}")

    out = train_loop(cfg, opt_cfg, mesh, stream, args.steps, run,
                     checkpoint_dir=args.ckpt, checkpoint_every=50,
                     start_step=start, params=params, opt_state=opt_state,
                     on_metrics=report)
    ckpt.wait_for_writes()
    if lead:
        print("training complete")
    if started:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
