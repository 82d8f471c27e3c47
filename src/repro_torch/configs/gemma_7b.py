"""gemma-7b [dense] — arXiv:2403.08295 (hf).  GeGLU, head_dim=256, MHA
(kv == q heads on 7b; MQA is the 2b variant)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", num_layers=28, d_model=3072,
    num_heads=16, num_kv_heads=16, head_dim=256, d_ff=24576,
    vocab_size=256_000, activation="geglu", rope_theta=10_000.0,
    tie_embeddings=True)

def smoke_config():
    return ModelConfig(
        name="gemma-7b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=512, activation="geglu")
