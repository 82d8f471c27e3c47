"""Serve a small LM with batched requests through the port's engine.

qwen3-4b's smoke config, weights drawn with ``init_params`` from a CPU
generator seeded with 0 and moved to the device, so a run on the card
and one on the CPU serve the same weights; 4 requests of 8 prompt
tokens, 16 new tokens each, greedy.

    PYTHONPATH=src python examples_torch/serve_lm.py --device cuda
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import params as pp
from repro_torch.serve.engine import Engine, ServeConfig


def run(cfg, params, device) -> dict:
    """Serve the example's 4 prompts on ``params`` (moved to
    ``device``); returns the config, the engine's parameters, the
    prompts and the (4, 24) tokens."""
    engine = Engine(cfg, params, ServeConfig(max_len=64), device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    out = engine.generate(prompts, steps=16)
    print("batched generation (4 requests, 8-token prompts, +16 tokens):")
    for i, row in enumerate(out):
        print(f"  req{i}: {row.tolist()}")
    return {"cfg": cfg, "params": engine.params, "prompts": prompts,
            "tokens": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("qwen3_4b")
    params = pp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return run(cfg, params, device)


if __name__ == "__main__":
    main()
