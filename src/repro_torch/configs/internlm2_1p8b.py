"""internlm2-1.8b [arXiv:2403.17297] — dense GQA.
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544,
    rope_theta=1e6,
    source="arXiv:2403.17297",
)
