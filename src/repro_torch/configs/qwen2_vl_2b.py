"""qwen2-vl-2b [arXiv:2409.12191] — VLM backbone (language decoder only).
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; M-RoPE with
(t,h,w) sections (16,24,24).  The ViT vision encoder + projector is a STUB:
input_specs() supplies precomputed patch/text embeddings (B,S,d_model) and
3-axis position ids — the assignment's modality carve-out."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    input_mode="embeddings",
    source="arXiv:2409.12191",
)
