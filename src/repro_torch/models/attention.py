"""GQA attention for training — the port of ``repro.models.attention``:
the chunked causal path (``impl="xla"``, O(chunk·S) scores, no S×S
matrix) and the flash kernel (``impl="pallas"``: the hand-written Hopper
kernel on the card, its plain version on the CPU).  qk-norm and M-RoPE
come with the transformer and vlm slices, decoding with the serving
slice.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import ModelConfig
from .layers import apply_rope, causal_mask_bias


def qkv_project(cfg: ModelConfig, p, x, positions):
    """x: (B,S,d) -> q (B,S,H,hd), k,v (B,S,KV,hd), with RoPE applied."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm or cfg.mrope:
        raise NotImplementedError("qk-norm and M-RoPE come with the "
                                  "transformer and vlm slices")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.expand_kv and cfg.num_kv_heads < cfg.num_heads:
        rep = cfg.num_heads // cfg.num_kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B,Sq,H,hd), k: (B,Sk,KV,hd) -> (B,KV,H/KV,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) / (hd ** 0.5)


def _gqa_out(probs, v):
    """probs: (B,KV,G,Sq,Sk), v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    B, Sq, KV, G, hd = out.shape
    return out.reshape(B, Sq, KV * G, hd)


def causal_attention(cfg: ModelConfig, q, k, v, *, q_chunk: int = 512,
                     window: int = 0):
    """Chunked causal self-attention: a loop over query chunks, each
    attending to the full (or windowed) prefix, so the scores are
    O(q_chunk · S) at a time instead of O(S²)."""
    B, S, H, hd = q.shape
    window = window or cfg.sliding_window
    q_chunk = min(q_chunk, S)
    if S % q_chunk:
        raise ValueError(f"seq_len {S} is not a multiple of the query "
                         f"chunk {q_chunk}")
    k_pos = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, S, q_chunk):
        scores = _gqa_scores(q[:, c0:c0 + q_chunk], k)       # (B,KV,G,qc,S)
        bias = causal_mask_bias(k_pos[c0:c0 + q_chunk], k_pos, window)
        probs = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
        outs.append(_gqa_out(probs, v))
    return torch.cat(outs, dim=1)


def attention_block(cfg: ModelConfig, p, x, positions, *, impl: str = "xla",
                    window: int = 0):
    """The train attention sub-layer (no residual/norm), x: (B,S,d) ->
    (B,S,d)."""
    q, k, v = qkv_project(cfg, p, x, positions)
    if impl == "pallas":
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=window or cfg.sliding_window)
    else:
        out = causal_attention(cfg, q, k, v, window=window)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.q_dim) @ p["wo"]
