"""Model configuration schema + the 10 assigned architectures.

Every architecture is expressed in one dataclass; ``block_pattern`` encodes
heterogeneous stacks (hybrid/ssm archs) as a repeating unit, scanned as a
super-block.  Exact figures follow the assignment table (sources noted in
each config module under repro_torch/configs/).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0          # shared (always-on) experts
    d_expert: int = 0            # expert FFN width
    capacity_factor: float = 1.25
    valiant_shuffle: bool = False  # paper's random-reorder analogue (§4 DESIGN)
    router_zloss: float = 1e-3
    # Exact SwiGLU decomposition of each expert into `expert_split` thinner
    # experts (split f columns; duplicate routing weights).  Lets an expert
    # count that does not divide the model axis become expert-parallel
    # (grok: 8 experts x split 2 = 16 — §Perf H2).
    expert_split: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "swiglu"   # swiglu | geglu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    # Heterogeneous stacks: repeating unit of block kinds; None = ["attn"].
    # kinds: attn, local_attn, mlstm, slstm, rglru, moe (ffn follows attn
    # blocks implicitly; moe blocks use MoEConfig for their ffn)
    block_pattern: Optional[Tuple[str, ...]] = None
    attn_window: Optional[int] = None       # local attention window
    moe: Optional[MoEConfig] = None
    dense_first_layers: int = 0             # MoE archs with dense first N
    # Modality frontends are stubs: input_specs() supplies embeddings.
    frontend: Optional[str] = None          # encodec_stub | siglip_stub
    num_codebooks: int = 1                  # audio heads (musicgen)
    prefix_len: int = 0                     # vlm image-prefix tokens
    # ssm internals
    lstm_proj_factor: float = 2.0
    lru_width: Optional[int] = None
    conv_width: int = 4
    # serving
    max_seq_len: int = 8192

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("attn",)

    def param_count(self) -> int:
        """Total parameters (embedding + blocks), for 6ND roofline math."""
        from repro_torch.models.params import count_params_config
        return count_params_config(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params_config
        return count_params_config(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}

# Architectures whose attention is fully quadratic skip long_500k (the skip
# is recorded in docs/ARCHITECTURE.md#design-5); SSM/hybrid archs run it.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True
