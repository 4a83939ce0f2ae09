"""musicgen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.
48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144 vocab=2048.  The EnCodec
conv codec (mel/conv frontend) is the STUB — inputs are the precomputed
discrete audio tokens, per the assignment's modality carve-out."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    rope_theta=1e4,
    source="arXiv:2306.05284",
)
