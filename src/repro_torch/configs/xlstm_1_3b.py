"""xlstm-1.3b [ssm] — arXiv:2405.04517 (unverified).  sLSTM + mLSTM blocks,
xLSTM[7:1] ratio, d_ff=0 (blocks carry their own projections)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=4, num_kv_heads=4, head_dim=512, d_ff=0,
    vocab_size=50_304, lstm_proj_factor=1.0, tie_embeddings=True,
    block_pattern=("mlstm",) * 7 + ("slstm",))

def smoke_config():
    return ModelConfig(
        name="xlstm-smoke", family="ssm", num_layers=4, d_model=64,
        num_heads=2, num_kv_heads=2, head_dim=32, d_ff=0, vocab_size=512,
        lstm_proj_factor=2.0, block_pattern=("mlstm", "slstm"))
