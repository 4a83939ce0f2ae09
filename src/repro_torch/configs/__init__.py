"""Architecture registry — the port of ``repro.configs``.

Each module defines ``CONFIG`` (exact published dims, source cited) on
the port's ``ModelConfig``; ``get(name)`` returns it.  ``reduced(cfg)``
builds the reference's ≤2-layer smoke variant used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.common import ModelConfig

ARCH_IDS = [
    "granite_moe_1b_a400m",
    "internlm2_1p8b",
    "qwen2_vl_2b",
    "musicgen_medium",
    "recurrentgemma_9b",
    "llama4_scout_17b_a16e",
    "yi_9b",
    "falcon_mamba_7b",
    "stablelm_12b",
    "qwen3_0p6b",
]

# CLI-friendly aliases (assignment spelling -> module name), the reference's
ALIASES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "internlm2-1.8b": "internlm2_1p8b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "yi-9b": "yi_9b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-0.6b": "qwen3_0p6b",
}


def get(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; available: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f".{mod_name}", __package__).CONFIG


def all_configs() -> dict:
    return {a: get(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The reference's smoke variant (≤2 layers, 3 for the hybrid;
    d_model≤256, ≤4 experts), field for field."""
    d = min(cfg.d_model, 256)
    heads = max(1, min(cfg.num_heads, 4))
    kw = dict(
        num_layers=min(cfg.num_layers, 3 if cfg.family == "hybrid" else 2),
        d_model=d, num_heads=heads,
        num_kv_heads=max(1, min(cfg.num_kv_heads, heads)), head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else 0,
        moe_group_size=64)
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 4),
                  experts_per_token=min(cfg.experts_per_token, 2),
                  moe_d_ff=min(cfg.moe_d_ff, 128))
    if cfg.family == "ssm":
        kw.update(d_inner=2 * d, dt_rank=max(8, d // 16),
                  ssm_state=cfg.ssm_state)
    if cfg.family == "hybrid":
        kw.update(lru_width=d, local_window=min(cfg.local_window, 64))
    if cfg.sliding_window:
        kw.update(sliding_window=min(cfg.sliding_window, 64))
    if cfg.mrope:
        kw.update(mrope_sections=(8, 12, 12))   # head_dim 64 -> half 32
    return dataclasses.replace(cfg, **kw)
