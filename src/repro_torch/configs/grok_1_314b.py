"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified).  8 experts top-2,
GQA kv=8, logit softcap 30."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", num_layers=64, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=32768,
    vocab_size=131_072, activation="geglu", logit_softcap=30.0,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=0, d_expert=32768,
                  expert_split=2))

def smoke_config():
    return ModelConfig(
        name="grok-1-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512, activation="geglu", logit_softcap=30.0,
        block_pattern=("moe",),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared=0, d_expert=64))
