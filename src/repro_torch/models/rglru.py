"""Griffin recurrent block with the Real-Gated LRU (RG-LRU) —
recurrentgemma-9b [arXiv:2402.19427] — the port of ``repro.models.rglru``.

    r_t = sigmoid(W_a x_t)                 (recurrence gate)
    i_t = sigmoid(W_x x_t)                 (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)      (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

``rg_lru(impl="pallas")`` routes the recurrence through ``kernels.ops``
(the hand-written Hopper kernel on the card, its plain version on the
CPU); ``impl="xla"`` runs it as a Python loop over time.  Streaming
decode waits for the serving slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig
from .mamba import _causal_conv

_C = 8.0


def rg_lru(p, x, *, impl: str = "xla"):
    """x: (B,S,W) -> (y, h_final).  Gates are per-channel diagonal."""
    B, S, W = x.shape
    r = torch.sigmoid(x @ p["w_a"])                      # (B,S,W)
    i = torch.sigmoid(x @ p["w_x"])
    log_a = -_C * F.softplus(p["lambda_p"].float()) * r.float()
    a = torch.exp(log_a)
    gated = (i * x).float() * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    if impl == "pallas":
        # the reference casts the scan's inputs to x's dtype, and takes
        # h_final from the cast trajectory
        ys = ops.rglru_scan(a.to(x.dtype), gated.to(x.dtype))
        return ys, ys[:, -1, :].float()
    h = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = a[:, t] * h + gated[:, t]
        ys.append(h.to(x.dtype))
    return torch.stack(ys, dim=1), h


def recurrent_block(cfg: ModelConfig, p, x, *, impl: str = "xla"):
    """Griffin temporal-mixing block, x: (B,S,d) -> (B,S,d): (linear →
    conv1d → RG-LRU) ⊙ (linear → gelu), then the out-projection.  gelu is
    the tanh approximation, ``jax.nn.gelu``'s default."""
    u = _causal_conv(x @ p["in_proj_rnn"], p["conv_w"], p["conv_b"])
    g = F.gelu(x @ p["in_proj_gate"], approximate="tanh")
    y, _ = rg_lru(p, u, impl=impl)
    return (y * g) @ p["out_proj"]
