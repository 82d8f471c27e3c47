"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (hf).  RG-LRU + local
attention, pattern (rec, rec, attn); MQA kv=1, window 2048, GeGLU."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
    num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680,
    vocab_size=256_000, activation="geglu", attn_window=2048,
    lru_width=2560, block_pattern=("rglru", "rglru", "local_attn"),
    tie_embeddings=True)

def smoke_config():
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid", num_layers=3,
        d_model=64, num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128,
        vocab_size=512, activation="geglu", attn_window=16, lru_width=64,
        block_pattern=("rglru", "rglru", "local_attn"))
