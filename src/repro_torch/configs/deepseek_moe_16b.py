"""deepseek-moe-16b [moe] — arXiv:2401.06066 (hf).  Fine-grained MoE:
64 routed experts top-6 + 2 shared, d_expert=1408, dense first layer."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=10944,
    vocab_size=102_400, activation="swiglu", dense_first_layers=1,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408))

def smoke_config():
    return ModelConfig(
        name="deepseek-moe-smoke", family="moe", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=256,
        vocab_size=512, activation="swiglu", dense_first_layers=1,
        block_pattern=("moe",),
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_expert=32))
