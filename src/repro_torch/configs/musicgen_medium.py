"""musicgen-medium [audio] — arXiv:2306.05284 (hf).  Decoder-only over
EnCodec tokens; 4 codebooks, vocab 2048/codebook; frontend stubbed to
precomputed frame embeddings per the assignment brief."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
    num_heads=24, num_kv_heads=24, head_dim=64, d_ff=6144,
    vocab_size=2048, activation="swiglu", frontend="encodec_stub",
    num_codebooks=4)

def smoke_config():
    return ModelConfig(
        name="musicgen-smoke", family="audio", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
        activation="swiglu", frontend="encodec_stub", num_codebooks=4)
