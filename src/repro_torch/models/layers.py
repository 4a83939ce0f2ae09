"""Shared building blocks — the port of ``repro.models.layers``: norms,
the SwiGLU FFN, RoPE and M-RoPE, the causal mask, initializers."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .shard_ctx import project


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 with a (1 + scale) gain, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(project(x, w_gate)) * project(x, w_up)
    return project(h, w_down)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16, *, device):
    """fan_in^-½-scaled normal, drawn in float32 from ``gen`` on
    ``device`` (no default: nothing lands on the CPU unless asked), then
    cast."""
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


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL M-RoPE [arXiv:2409.12191]: the rotary half-dims are split
    into (temporal, height, width) sections, each rotated by its own
    position stream.  x: (B, S, H, hd); positions3: (3, B, S) integers;
    ``sections`` sums to hd // 2."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"half the head dim, {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)    # (half,)
    # the position stream of each frequency: section i's ids repeated
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=half)                                      # (half,)
    pos = positions3[sec_id].movedim(0, -1).float()            # (B, S, half)
    ang = (pos * freqs)[..., None, :]                          # (B, S, 1, half)
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
