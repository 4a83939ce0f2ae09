"""recurrentgemma-9b [arXiv:2402.19427] — Griffin hybrid: RG-LRU recurrent
blocks + local attention, pattern (rec, rec, attn) = 1:2 attn:recurrent.
38L d_model=4096 16H (GQA kv=1 -> MQA) head_dim=256 d_ff=12288 vocab=256000,
local window 2048, lru_width=4096."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rec", "rec", "attn"), lru_width=4096, local_window=2048,
    rope_theta=1e4,
    source="arXiv:2402.19427",
)
