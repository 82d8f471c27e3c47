"""The paper's random-reordering insight applied to MoE routing, on the
port.

Runs the deepseek-family MoE layer (``repro_torch.models.moe``) with
skewed token->expert assignment and reports the per-expert load and the
capacity-dropped tokens with and without the Valiant shuffle — the
Fig. 8 vs Fig. 11 comparison on an LM workload.  Weights and tokens are
drawn from a CPU generator seeded with 0 and the shuffle's permutation
from one seeded with 7, then moved to the device, so the card and the
CPU run the same numbers.  At the smoke config neither run drops a
token (0.000 both), as in ``examples/moe_valiant.py``.

    PYTHONPATH=src python examples_torch/moe_valiant.py --device cuda
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.moe import expert_load, moe_ffn, route, shuffle_perm

D_MODEL = 64
TOKENS = (4, 64)                       # (B, S)


def draw(cfg, generator):
    """The example's parameters and (B, S, d) bf16 tokens on the CPU: a
    router skewed toward expert 0 (the cop20k_A hot-spot)."""
    E, f, d = cfg.num_experts, cfg.d_expert, D_MODEL

    def normal(*shape):
        return torch.randn(shape, generator=generator)
    router = normal(d, E) * 0.02
    router[:, 0] += 0.5
    params = {"router": router,
              "w_gate": (normal(E, d, f) * 0.05).to(torch.bfloat16),
              "w_up": (normal(E, d, f) * 0.05).to(torch.bfloat16),
              "w_down": (normal(E, f, d) * 0.05).to(torch.bfloat16)}
    return params, normal(*TOKENS, d).to(torch.bfloat16)


def run(cfg, params, x, perm, device) -> dict:
    """Route ``x`` and run the layer plain and with the Valiant shuffle
    (permutation ``perm``), on ``device``."""
    params = {k: v.to(device) for k, v in params.items()}
    x, perm = x.to(device), perm.to(device)
    d = x.shape[-1]
    _, ids, _ = route(params, x.reshape(-1, d), cfg)
    load = expert_load(ids, cfg.num_experts).cpu().numpy()
    print(f"expert load (skewed router): {load.astype(int).tolist()}")
    print(f"  hot expert share: {load.max()/load.sum():.2f}  "
          f"CV: {load.std()/load.mean():.2f}")
    y0, _ = moe_ffn(params, x, cfg, "swiglu")
    cfg2 = dataclasses.replace(cfg, valiant_shuffle=True)
    y1, _ = moe_ffn(params, x, cfg2, "swiglu", perm=perm)
    drop0, drop1 = (float(((y.float().abs().sum(-1)) == 0).float().mean())
                    for y in (y0, y1))
    print(f"capacity-dropped tokens: plain={drop0:.3f} valiant={drop1:.3f}")
    print("(the shuffle spreads correlated token runs across the capacity")
    print(" buffer exactly like the paper's random reordering spreads")
    print(" migratory threads across nodelets)")
    return {"ids": ids, "load": load, "drop": (drop0, drop1),
            "y": (y0, y1)}


def inputs():
    """(cfg, params, x, perm) on the CPU, from the example's seeds."""
    cfg = get_smoke_config("deepseek_moe_16b").moe
    params, x = draw(cfg, torch.Generator().manual_seed(0))
    perm = shuffle_perm(x.shape[0] * x.shape[1], "cpu",
                        torch.Generator().manual_seed(7))
    return cfg, params, x, perm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(*inputs(), resolve_device(args.device))


if __name__ == "__main__":
    main()
