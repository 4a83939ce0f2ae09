"""GQA attention — the port of ``repro.models.attention``: for training
and prefill the chunked causal path (``impl="xla"``, O(chunk·S) scores,
no S×S matrix) and the flash kernel (``impl="pallas"``: the hand-written
Hopper kernel on the card, its plain version on the CPU), with qk-norm
and M-RoPE in ``qkv_project``; for decoding one token against a KV
cache, a ring buffer of the window's size under a sliding window.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import ModelConfig
from .layers import apply_mrope, apply_rope, causal_mask_bias, rms_norm
from .shard_ctx import heads_local, reshape, shard, split_heads


def qkv_project(cfg: ModelConfig, p, x, positions):
    """x: (B,S,d) -> q (B,S,H,hd), k,v (B,S,KV,hd): q and k RMS-normed
    over the head dim under qk-norm, then rotated (RoPE, or M-RoPE with
    (3, B, S) positions)."""
    q = split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    k = split_heads(x @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(x @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
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
    qg = reshape(q, (B, Sq, KV, H // KV, hd))
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) / (hd ** 0.5)


def _gqa_out(probs, v):
    """probs: (B,KV,G,Sq,Sk), v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    B, Sq, KV, G, hd = out.shape
    return reshape(out, (B, Sq, KV * G, hd))


def causal_attention(cfg: ModelConfig, q, k, v, *, q_chunk: int = 512,
                     window: int = 0, q_offset: int = 0):
    """Chunked causal self-attention: a loop over query chunks, each
    attending to the full (or windowed) prefix, so the scores are
    O(q_chunk · S) at a time instead of O(S²).  ``q_offset``: the position
    of q's first row among k's (a block of the queries)."""
    B, S, H, hd = q.shape
    window = window or cfg.sliding_window
    q_chunk = min(q_chunk, S)
    if S % q_chunk:
        raise ValueError(f"seq_len {S} is not a multiple of the query "
                         f"chunk {q_chunk}")
    k_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c0 in range(0, S, q_chunk):
        scores = _gqa_scores(q[:, c0:c0 + q_chunk], k)       # (B,KV,G,qc,S)
        c = q_offset + c0
        bias = causal_mask_bias(k_pos[c:c + q_chunk], k_pos, window)
        probs = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
        outs.append(_gqa_out(probs, v))
    return torch.cat(outs, dim=1)


def decode_attention(cfg: ModelConfig, q, k_cache, v_cache, cache_len: int):
    """q: (B,1,H,hd); caches: (B,S,KV,hd) with the new K/V already
    written.  Cache slots at or beyond ``cache_len`` are masked."""
    S = k_cache.shape[1]
    scores = _gqa_scores(q, k_cache)                      # (B,KV,G,1,S)
    pos = torch.arange(S, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(pos < cache_len, zero, float("-inf"))
    probs = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
    return _gqa_out(probs, v_cache)                       # (B,1,H,hd)


def attention_block(cfg: ModelConfig, p, x, positions, *, impl: str = "xla",
                    window: int = 0, return_kv: bool = False):
    """The train and prefill attention sub-layer (no residual/norm),
    x: (B,S,d) -> (B,S,d); with ``return_kv`` also the (k, v) tensors that
    fill the cache."""
    q, k, v = qkv_project(cfg, p, x, positions)
    # "+attnb": batch over the whole mesh for the attention einsums (GQA
    # head counts rarely divide the model axis); back after the output
    # projection
    q = shard(q, "attn_batch")
    k = shard(k, "attn_batch")
    v = shard(v, "attn_batch")
    if impl == "pallas":
        out = heads_local(lambda q, k, v: ops.flash_attention(
            q, k, v, causal=True, window=window or cfg.sliding_window),
            q, k, v)
    else:
        out = heads_local(lambda q, k, v, q_offset=0: causal_attention(
            cfg, q, k, v, window=window, q_offset=q_offset), q, k, v,
            query_blocks=True)
    B, S = x.shape[:2]
    out = shard(reshape(out, (B, S, cfg.q_dim)), "act_btd_full")
    y = out @ p["wo"]
    return (y, (k, v)) if return_kv else y


def decode_attention_block(cfg: ModelConfig, p, x, cache, position: int, *,
                           window: int = 0):
    """One-token decode step.  x: (B,1,d); cache: {"k": (B,S,KV,hd),
    "v": ...}; ``position`` is the absolute position of the new token.
    Under a sliding window the cache is a ring buffer of size window: the
    token lands at slot position % S.  The new K/V rows are written into
    ``cache`` in place (a slice ``copy_``, no copy of the rest of
    the cache), and the same dict is returned: the caller's cache is
    consumed."""
    B = x.shape[0]
    position = int(position)
    pos = torch.full((B, 1), position, dtype=torch.long, device=x.device)
    q, k, v = qkv_project(cfg, p, x,
                          pos.expand(3, B, 1) if cfg.mrope else pos)
    S = cache["k"].shape[1]
    slot = position % S                                       # ring buffer
    cache["k"][:, slot:slot + 1].copy_(k)
    cache["v"][:, slot:slot + 1].copy_(v)
    out = decode_attention(cfg, q, cache["k"], cache["v"],
                           min(position + 1, S))
    return reshape(out, (B, 1, cfg.q_dim)) @ p["wo"], cache
