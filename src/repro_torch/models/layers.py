"""Shared building blocks — the port of ``repro.models.layers``: norms,
the SwiGLU FFN, RoPE, the causal mask, initializers.  M-RoPE comes with
the vlm slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 with a (1 + scale) gain, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16, device="cpu"):
    """fan_in^-½-scaled normal, drawn in float32 from ``gen`` (on
    ``device``), then cast."""
    std = shape[in_axis] ** -0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return (std * out).to(dtype)


# ----------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integers.  Rotates the two
    halves of the head dimension (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    ang = ang[..., None, :]                                   # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_mask_bias(q_pos, k_pos, window: int = 0):
    """(..., Sq, Sk) additive float32 bias: -inf where k > q or (window > 0
    and q - k >= window), else 0."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        ok = ok & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))
