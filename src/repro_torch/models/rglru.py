"""Griffin recurrent block with the Real-Gated LRU (RG-LRU) —
recurrentgemma-9b [arXiv:2402.19427] — the port of ``repro.models.rglru``.

    r_t = sigmoid(W_a x_t)                 (recurrence gate)
    i_t = sigmoid(W_x x_t)                 (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)      (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

``rg_lru(impl="pallas")`` routes the recurrence through ``kernels.ops``
(the hand-written Hopper kernel on the card, its plain version on the
CPU); ``impl="xla"`` runs it as a Python loop over time, from zeros or
from a carried ``h0``.  Decoding is one recurrence step on the carried
state (O(1) in the context length); as in the reference, a given ``h0``
always takes the loop, since the kernel starts from zeros.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig
from .mamba import _causal_conv
from .shard_ctx import channels_local

_C = 8.0


def rg_lru(p, x, h0=None, *, impl: str = "xla"):
    """x: (B,S,W) -> (y, h_final).  Gates are per-channel diagonal."""
    return _rg_lru(p, x, x, h0, impl)


def _rg_lru(p, x, x_all, h0, impl: str):
    """``rg_lru`` on a shard of the channels: x (B,S,W) those channels,
    ``x_all`` all of them, which the gates' products mix."""
    B, _, W = x.shape
    r = torch.sigmoid(x_all @ p["w_a"])                  # (B,S,W)
    i = torch.sigmoid(x_all @ p["w_x"])
    log_a = -_C * F.softplus(p["lambda_p"].float()) * r.float()
    a = torch.exp(log_a)
    gated = (i * x).float() * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    if impl == "pallas" and h0 is None:
        # the reference casts the scan's inputs to x's dtype, and takes
        # h_final from the cast trajectory (the loop returns its float32
        # carry)
        ys = ops.rglru_scan(a.to(x.dtype), gated.to(x.dtype))
        return ys, ys[:, -1, :].float()
    h = h0 if h0 is not None else torch.zeros((B, W), dtype=torch.float32,
                                              device=x.device)
    ys = []
    # one unbind a tensor, not a select a step: a select's backward fills
    # a zero tensor of the whole sequence every step
    for a_t, g_t in zip(a.unbind(1), gated.unbind(1)):
        h = a_t * h + g_t
        ys.append(h.to(x.dtype))
    return torch.stack(ys, dim=1), h


# the block's parameters as ``shard_ctx.channels_local`` lays them out:
# channels on the columns, per channel, on the rows
_COLS = ("in_proj_rnn", "in_proj_gate", "w_a", "w_x")
_CHANNELS = ("conv_w", "conv_b", "lambda_p")
_ROWS = ("out_proj",)


def recurrent_block(cfg: ModelConfig, p, x, state=None, *,
                    return_state: bool = False, impl: str = "xla"):
    """Griffin temporal-mixing block, x: (B,S,d) -> (B,S,d): (linear →
    conv1d → RG-LRU) ⊙ (linear → gelu), then the out-projection.  gelu is
    the tanh approximation, ``jax.nn.gelu``'s default.

    With ``state`` ({"conv": (B,W-1,w), "h": (B,w)}) it runs streaming
    decode and returns (y, new_state); with ``return_state`` (prefill) it
    returns the final streaming state beside the full-sequence output.
    Under a mesh the block runs on local shards of the LRU width
    (``shard_ctx.channels_local``)."""
    def body(x, p, state, gather, reduce):
        u_raw = x @ p["in_proj_rnn"]                     # (B,S,w)
        g = F.gelu(x @ p["in_proj_gate"], approximate="tanh")
        if state is not None:
            u, conv_state = _causal_conv(u_raw, p["conv_w"], p["conv_b"],
                                         state["conv"])
            y, h = _rg_lru(p, u, gather(u), state["h"], "xla")
            return (y * g) @ p["out_proj"], {"conv": conv_state, "h": h}
        u = _causal_conv(u_raw, p["conv_w"], p["conv_b"])
        y, h = _rg_lru(p, u, gather(u), None, impl)
        out = (y * g) @ p["out_proj"]
        if return_state:
            W = p["conv_w"].shape[1]
            return out, {"conv": u_raw[:, -(W - 1):, :], "h": h}
        return out, None

    out, new = channels_local(body, x, {k: p[k] for k in _COLS},
                              {k: p[k] for k in _CHANNELS},
                              {k: p[k] for k in _ROWS}, state)
    return (out, new) if state is not None or return_state else out
