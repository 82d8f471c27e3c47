"""End-to-end driver on the port: train a small qwen3-family model for a
few hundred steps on the host mesh, with checkpoints and restart.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200 \\
        --d-model 256 --device cuda

The config is the qwen3 family (GQA + qk_norm) scaled down (24.0M
parameters at the defaults, as the script prints); the loop is the same
`train_loop` the port's launcher uses (remat, in-place updates, grad
accumulation, checkpoint/restart), on one device.
Checkpoints go to ``--ckpt`` (``/tmp/repro_torch_ckpt``), every 50 steps.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data.synthetic import DataConfig, TokenStream
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import count_params_config, tree_map
from repro_torch.optim import adamw
from repro_torch.train import checkpoint
from repro_torch.train.loop import RunConfig, train_loop


def model_config(d_model: int, layers: int) -> ModelConfig:
    return ModelConfig(
        name="qwen3-100m", family="dense", num_layers=layers,
        d_model=d_model, num_heads=8, num_kv_heads=2,
        head_dim=d_model // 8, d_ff=d_model * 4,
        vocab_size=32_000, activation="swiglu", qk_norm=True)


def run(cfg, steps: int, batch: int, seq: int, ckpt: str, device, *,
        params=None) -> dict:
    """``steps`` steps of ``train_loop`` on ``device`` from ``params``
    (moved there; None: the loop's own seeded draw), checkpointing every
    50 steps into ``ckpt``.  Returns every step's metrics, the trained
    parameters and the host seconds between the reads of consecutive
    steps' metrics."""
    mesh = make_host_mesh(device=device)
    opt_state = None
    if params is not None:
        params = tree_map(lambda t: t.to(mesh.local_device), params)
        opt_state = adamw.init_state(params)
    stream = TokenStream(cfg, DataConfig(seed=0, batch=batch, seq_len=seq))
    run_cfg = RunConfig(fsdp=False, remat=True, donate=True, grad_accum=2)
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    metrics, stamps = [], []

    def report(step, m):
        stamps.append(time.perf_counter())
        metrics.append(m)
        if step % 10 == 0 or step == steps - 1:
            print(f"step {step:4d} loss={m['loss']:.4f} "
                  f"gnorm={m['gnorm']:.2f} lr={m['lr']:.2e}")

    t0 = time.perf_counter()
    params, _, _ = train_loop(
        cfg, opt, mesh, stream, steps, run_cfg, checkpoint_dir=ckpt,
        checkpoint_every=50, params=params, opt_state=opt_state,
        on_metrics=report)
    checkpoint.wait_for_writes()
    print("done; checkpoints in", ckpt)
    return {"metrics": metrics, "params": params,
            "step_s": [b - a for a, b in zip([t0] + stamps, stamps)]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config(args.d_model, args.layers)
    print(f"model: {count_params_config(cfg)/1e6:.1f}M params")
    return run(cfg, args.steps, args.batch, args.seq, args.ckpt, device)


if __name__ == "__main__":
    main()
