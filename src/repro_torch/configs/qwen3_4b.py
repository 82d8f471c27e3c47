"""qwen3-4b [dense] — hf:Qwen/Qwen3-8B family card.  GQA kv=8, qk_norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=9728,
    vocab_size=151_936, activation="swiglu", qk_norm=True,
    rope_theta=1_000_000.0)

def smoke_config():
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512, activation="swiglu", qk_norm=True)
