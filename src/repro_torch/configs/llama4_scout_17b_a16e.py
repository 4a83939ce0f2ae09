"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E].
48L d_model=5120 40H (GQA kv=8) vocab=202048, MoE 16 experts top-1 with a
shared expert (d_ff=8192 for both expert and shared FFN); early-fusion
multimodal — the vision frontend is stubbed (text-token path exercised)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1, moe_d_ff=8192, shared_expert=True,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
