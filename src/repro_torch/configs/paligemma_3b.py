"""paligemma-3b [vlm] — arXiv:2407.07726 (hf).  SigLIP patch embeddings
(stubbed) + gemma-2b backbone, MQA kv=1, prefix-LM over 256 image tokens."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
    vocab_size=257_216, activation="geglu", frontend="siglip_stub",
    prefix_len=256, tie_embeddings=True)

def smoke_config():
    return ModelConfig(
        name="paligemma-smoke", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
        activation="geglu", frontend="siglip_stub", prefix_len=8)
