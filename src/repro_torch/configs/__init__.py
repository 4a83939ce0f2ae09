"""Architecture registry — the port of ``repro.configs``.

``get(name)`` returns an architecture's ``ModelConfig`` (exact published
dims, source cited); ``reduced(cfg)`` builds the reference's ≤2-layer
smoke variant used by the CPU tests.  The port carries the architectures
whose layer families it has ported; the others raise and name the slice
that brings them.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.common import ModelConfig

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

# module -> config family of the architectures whose layer family is not
# ported yet; ``workloads.families.PENDING`` names the slice that brings it
PENDING = {
    "granite_moe_1b_a400m": "moe",
    "llama4_scout_17b_a16e": "moe",
    "internlm2_1p8b": "dense",
    "qwen2_vl_2b": "vlm",
    "musicgen_medium": "audio",
    "yi_9b": "dense",
    "stablelm_12b": "dense",
    "qwen3_0p6b": "dense",
}


class NotPortedError(ValueError):
    """A registered architecture whose layer family is not ported yet."""


def get(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name)
    if mod_name in PENDING:
        # imported here: the adapters import this registry
        from ..workloads.families import pending_slice
        raise NotPortedError(
            f"architecture {name!r} is not yet ported to repro_torch; it "
            f"comes with {pending_slice(PENDING[mod_name])}")
    if mod_name not in ALIASES.values():
        raise KeyError(f"unknown architecture {name!r}; available: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f".{mod_name}", __package__).CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The reference's smoke variant (≤2 layers, 3 for the hybrid;
    d_model≤256), field for field, for the families ``get`` returns (ssm
    and hybrid)."""
    d = min(cfg.d_model, 256)
    heads = max(1, min(cfg.num_heads, 4))
    kw = dict(
        num_layers=min(cfg.num_layers, 3 if cfg.family == "hybrid" else 2),
        d_model=d, num_heads=heads,
        num_kv_heads=max(1, min(cfg.num_kv_heads, heads)), head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else 0,
        moe_group_size=64)
    if cfg.family == "ssm":
        kw.update(d_inner=2 * d, dt_rank=max(8, d // 16),
                  ssm_state=cfg.ssm_state)
    if cfg.family == "hybrid":
        kw.update(lru_width=d, local_window=min(cfg.local_window, 64))
    return dataclasses.replace(cfg, **kw)
