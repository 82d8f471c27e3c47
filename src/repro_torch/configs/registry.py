"""Architecture registry: ``get_config(arch_id)`` + reduced smoke configs.

One module per architecture lives alongside this file; each exports CONFIG
(full assigned config) and ``smoke_config()`` (same family, tiny dims) used
by the per-arch CPU smoke tests.  Input specs for the dry-run are built here
as tensors on the ``meta`` device (shapes and dtypes only, no allocation).
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES, \
    shape_applicable

ARCH_IDS = (
    "gemma_7b", "qwen25_32b", "qwen3_4b", "command_r_plus_104b",
    "xlstm_1_3b", "recurrentgemma_2b", "musicgen_medium", "paligemma_3b",
    "deepseek_moe_16b", "grok_1_314b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# --------------------------------------------------------------------------
# dry-run input specs (meta tensors: shape and dtype, no storage)
# --------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, object]:
    """Model inputs for one (arch x shape) cell.

    train / prefill: token batch (+labels for train).  decode: one new token
    plus the KV/recurrent cache of seq_len (built by abstract_cache).
    Modality frontends are stubs: precomputed frame/patch embeddings.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16

    def token_batch(with_labels: bool):
        if cfg.frontend == "encodec_stub":
            d = {"frames": _spec((B, S, cfg.d_model), bf16)}
            if with_labels:
                d["labels"] = _spec((B, S, cfg.num_codebooks), i32)
            return d
        if cfg.frontend == "siglip_stub":
            P = cfg.prefix_len
            d = {
                "image_embeds": _spec((B, P, cfg.d_model), bf16),
                "tokens": _spec((B, S - P), i32),
            }
            if with_labels:
                d["labels"] = _spec((B, S - P), i32)
            return d
        d = {"tokens": _spec((B, S), i32)}
        if with_labels:
            d["labels"] = _spec((B, S), i32)
        return d

    if shape.kind == "train":
        return token_batch(with_labels=True)
    if shape.kind == "prefill":
        return token_batch(with_labels=False)
    if shape.kind == "decode":
        from repro_torch.models.model import abstract_cache
        return {
            "tokens": _spec((B, 1), i32),
            "caches": abstract_cache(cfg, B, S),
            "pos": _spec((), i32),
        }
    raise ValueError(shape.kind)


def grid_cells():
    """All 40 (arch x shape) cells with applicability flags."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            out.append((arch, sname, shape_applicable(cfg, shape)))
    return out
