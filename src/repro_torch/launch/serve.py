"""Serving launcher: build an engine for an arch and run batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
        --smoke --device cpu

Random weights from a seeded ``torch.Generator`` (the repo holds no
checkpoint).  Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import params as pp
    from repro_torch.serve.engine import Engine, ServeConfig

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = pp.init_params(cfg, gen, device=device)
    engine = Engine(cfg, params,
                    ServeConfig(max_len=args.prompt_len + args.gen + 8),
                    device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out = engine.generate(prompts, steps=args.gen)
    for i, row in enumerate(out):
        print(f"req{i}: {row.tolist()}")
    return out


if __name__ == "__main__":
    main()
