"""yi-9b [arXiv:2403.04652] — llama-arch dense GQA.
48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    rope_theta=1e4,
    source="arXiv:2403.04652",
)
