"""Model configuration shared by the architectures — the port of
``repro.models.common``.

The fields are the reference's, so a ``ModelSpec.overrides`` dict means
the same thing in both packages; ``dtype`` is a ``torch.dtype`` (bfloat16
by default, as the reference's ``jnp.bfloat16``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0                    # dense FFN hidden (0 => attn-free/MoE-only)
    vocab_size: int = 0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # expert FFN hidden
    shared_expert: bool = False      # llama4-style parallel shared FFN
    moe_group_size: int = 512        # GShard grouping (tokens per dispatch group)
    capacity_factor: float = 1.25

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0
    conv_width: int = 4

    # --- hybrid (RG-LRU + local attention, RecurrentGemma/Griffin) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    local_window: int = 0            # local-attention window for "attn" blocks

    # --- attention details ---
    rope_theta: float = 1e4
    qk_norm: bool = False
    mrope: bool = False              # qwen2-vl M-RoPE (t/h/w sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # half-dim split (t,h,w)
    sliding_window: int = 0          # >0: sliding-window attention (serve variant)
    expand_kv: bool = False          # repeat KV heads to H for clean TP

    # --- I/O ---
    input_mode: str = "tokens"       # tokens | embeddings (vlm/audio stubs)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    # citation for the config values
    source: str = ""

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def effective_kv_heads(self) -> int:
        """The KV heads a cache holds: every query head's under
        ``expand_kv``."""
        return self.num_heads if self.expand_kv else self.num_kv_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer block type, length == num_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.family == "hybrid":
            pat = self.block_pattern or ("rec", "rec", "attn")
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        if self.family == "moe":
            return ("moe",) * self.num_layers
        return ("attn_mlp",) * self.num_layers

    def active_params(self) -> int:
        """Parameters touched per token (MoE counts top-k experts only)."""
        return self._param_count(active_only=True)

    def total_params(self) -> int:
        return self._param_count(active_only=False)

    def _param_count(self, active_only: bool) -> int:
        d = self.d_model
        n = 0
        if self.input_mode == "tokens":
            n += self.vocab_size * d
        if self.vocab_size:
            n += d * self.vocab_size          # lm_head (untied)
        for t in self.layer_types():
            if t in ("attn_mlp", "moe"):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                n += 2 * d                     # norms
            if t == "attn_mlp":
                n += 3 * d * self.d_ff
            if t == "moe":
                e = self.experts_per_token if active_only else self.num_experts
                n += e * 3 * d * self.moe_d_ff + d * self.num_experts
                if self.shared_expert and self.d_ff:
                    n += 3 * d * self.d_ff
            if t == "ssm":
                di, st = self.d_inner, self.ssm_state
                n += d * 2 * di + di * self.conv_width
                n += di * (self.dt_rank + 2 * st) + self.dt_rank * di
                n += di * st + di + di * d + d
            if t == "rec":
                # Griffin recurrent block (two input projs, conv, RG-LRU
                # gates, out proj) + its MLP
                w = self.lru_width
                n += 2 * d * w + w * self.conv_width + 2 * w * w + 3 * w
                n += w * d + 3 * d * self.d_ff + 2 * d
            if t == "attn":                   # hybrid local-attention block
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                n += 3 * d * self.d_ff + 2 * d
        n += d                                # final norm
        return n
