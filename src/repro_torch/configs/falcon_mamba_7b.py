"""falcon-mamba-7b [arXiv:2410.05355] — pure mamba1 SSM, attention-free.
64L d_model=4096 d_inner=8192 ssm_state=16 dt_rank=256 conv=4 vocab=65024."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, d_inner=8192, dt_rank=256, conv_width=4,
    source="arXiv:2410.05355",
)
