"""qwen3-0.6b [hf:Qwen/Qwen3-8B family card] — dense GQA with qk-norm.
28L d_model=1024 16H (GQA kv=8) head_dim=128 d_ff=3072 vocab=151936."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
