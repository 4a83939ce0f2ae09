"""Assigned input shapes and meta-tensor stand-ins for every model input
— the port of ``repro.launch.specs``: the reference's
``ShapeDtypeStruct``s are meta tensors here (shapes and dtypes, nothing
allocated)."""
from __future__ import annotations

import torch

from ..models import transformer as T
from ..models.common import ModelConfig

# name -> (seq_len, global_batch, kind)
INPUT_SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# dense-family archs need the sliding-window serve variant for long_500k;
# SSM/hybrid run it natively.
LONG_CONTEXT_WINDOW = 8192


def serve_config(cfg: ModelConfig, shape: str) -> ModelConfig:
    """Adapt a config for an inference shape (sliding-window carve-out)."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta-tensor dict for the step's input batch."""
    S, B, kind = INPUT_SHAPES[shape]
    if kind in ("train", "prefill"):
        if cfg.input_mode == "tokens":
            batch = {"tokens": _meta((B, S), torch.int32)}
        else:
            batch = {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                     "positions": _meta((3, B, S), torch.int32)}
        if kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
        return batch
    # decode: one new token at position S-1 over a cache of length S
    if cfg.input_mode == "tokens":
        batch = {"tokens": _meta((B, 1), torch.int32)}
    else:
        batch = {"embeds": _meta((B, 1, cfg.d_model), torch.bfloat16)}
    batch["position"] = _meta((), torch.int32)
    return batch


def cache_specs(cfg: ModelConfig, shape: str) -> dict:
    S, B, kind = INPUT_SHAPES[shape]
    if kind != "decode":
        raise ValueError(f"{shape} is a {kind} shape; only decode shapes "
                         f"have a cache")
    return T.init_cache(cfg, B, S, device="meta")


def concrete_batch(cfg: ModelConfig, shape: str,
                   generator: torch.Generator | None = None) -> dict:
    """A materialized batch matching ``batch_specs`` on ``generator``'s
    device: token ids and embeddings drawn from ``generator`` (a fresh
    CPU one seeded 0 by default), positions 0..S-1, the decode position
    S-1."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    device = generator.device
    S = INPUT_SHAPES[shape][0]
    out = {}
    for name, s in batch_specs(cfg, shape).items():
        if name in ("tokens", "labels"):
            out[name] = torch.randint(0, max(2, cfg.vocab_size), s.shape,
                                      generator=generator, device=device,
                                      dtype=s.dtype)
        elif name == "positions":
            out[name] = torch.arange(s.shape[-1], dtype=s.dtype,
                                     device=device).expand(s.shape).clone()
        elif name == "position":
            out[name] = torch.tensor(S - 1, dtype=s.dtype, device=device)
        else:
            out[name] = torch.randn(s.shape, generator=generator,
                                    device=device).to(s.dtype)
    return out
