"""qwen2.5-32b [dense] — hf:Qwen/Qwen2.5-0.5B family card.  GQA kv=8,
QKV bias, SwiGLU."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=27648,
    vocab_size=152_064, activation="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0)

def smoke_config():
    return ModelConfig(
        name="qwen2.5-32b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512, activation="swiglu", qkv_bias=True)
