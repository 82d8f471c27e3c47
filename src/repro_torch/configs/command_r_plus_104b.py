"""command-r-plus-104b [dense] — hf:CohereForAI/c4ai-command-r-v01
(unverified).  GQA kv=8, no biases."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense", num_layers=64,
    d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256_000, activation="swiglu",
    rope_theta=75_000.0)

def smoke_config():
    return ModelConfig(
        name="command-r-plus-smoke", family="dense", num_layers=2,
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8, d_ff=128,
        vocab_size=512, activation="swiglu")
