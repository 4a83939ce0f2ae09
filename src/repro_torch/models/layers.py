"""Shared building blocks — the port of ``repro.models.layers``.

This slice carries what the ssm family needs: ``rms_norm`` and
``dense_init``.  RoPE and SwiGLU come with the attention families."""
from __future__ import annotations

import torch


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 with a (1 + scale) gain, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16, device="cpu"):
    """fan_in^-½-scaled normal, drawn in float32 from ``gen`` (on
    ``device``), then cast."""
    std = shape[in_axis] ** -0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return (std * out).to(dtype)
