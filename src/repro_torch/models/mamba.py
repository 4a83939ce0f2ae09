"""Mamba-1 block (falcon-mamba-7b [arXiv:2410.05355]) — the port of
``repro.models.mamba``.

``selective_scan`` is the time-sequential recurrence written out in
PyTorch, with a small carried state (B, d_inner, ssm_state), from zeros or
from a given ``h0``.  ``mamba_block(impl="pallas")`` routes the scan through
``kernels.ops`` instead: the hand-written Hopper kernel on the card, its
plain version on the CPU.  The impl name is the reference's, so a spec or a
test reads the same in both packages.  Prefill (``return_state``) and
decoding (``mamba_decode_step``, one recurrence step on the carried state,
O(1) in the context length) need the final state, which the kernel does
not return: as in the reference, ``return_state`` runs the plain scan
whatever ``impl`` says, so prefill never launches the kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig
from .shard_ctx import channels_local


def _causal_conv(x, conv_w, conv_b, state=None):
    """Depthwise causal conv over time.  x: (B,S,di), conv_w: (di, W).
    With ``state`` ((B, W-1, di), the last inputs) it runs in streaming
    mode and returns (y, new_state)."""
    W = conv_w.shape[1]
    if state is not None:
        xin = torch.cat([state, x], dim=1)                  # (B, W-1+S, di)
    else:
        xin = torch.cat([torch.zeros_like(x[:, : W - 1]), x], dim=1)
    # y[:, t, c] = sum_w xin[:, t+w, c] * conv_w[c, w]
    ys = sum(xin[:, w:w + x.shape[1], :] * conv_w[:, w] for w in range(W))
    y = ys + conv_b
    return (y, xin[:, -(W - 1):, :]) if state is not None else y


def _ssm_inputs(cfg: ModelConfig, p, u, reduce=None):
    """u: (B,S,di) post-conv activations -> (delta, B_ssm, C_ssm).
    delta: (B,S,di); B_ssm/C_ssm: (B,S,state).  ``reduce`` sums the
    x_proj contraction over the channel shards (``channels_local``)."""
    proj = u @ p["x_proj"]                                  # (B,S,R+2N)
    if reduce is not None:
        proj = reduce(proj)
    R, N = cfg.dt_rank, cfg.ssm_state
    dt, B_ssm, C_ssm = torch.split(proj, [R, N, N], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])    # (B,S,di)
    return delta, B_ssm, C_ssm


def selective_scan(cfg: ModelConfig, p, u, delta, B_ssm, C_ssm, h0=None):
    """Returns (y (B,S,di), h_final (B,di,N) float32), from ``h0`` or a
    zero state.  A = -exp(A_log)."""
    A = -torch.exp(p["A_log"].float())                      # (di, N)
    Bsz, _, di = u.shape
    h = h0 if h0 is not None else torch.zeros(
        (Bsz, di, cfg.ssm_state), dtype=torch.float32, device=u.device)
    ys = []
    # one unbind a tensor, not a select a step: a select's backward fills
    # a zero tensor of the whole sequence every step
    for u_t, d_t, b_t, c_t in zip(u.unbind(1), delta.unbind(1),
                                  B_ssm.unbind(1), C_ssm.unbind(1)):
        dA = torch.exp(d_t[..., None].float() * A)          # (B,di,N)
        dBu = (d_t * u_t)[..., None].float() * b_t[:, None, :].float()
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, c_t.float()).to(u.dtype))
    y = (torch.stack(ys, dim=1).float()
         + u.float() * p["D"]).to(u.dtype)                  # skip connection
    return y, h


# the block's parameters as ``shard_ctx.channels_local`` lays them out:
# d_inner on the columns, per channel, on the rows
_COLS = ("in_proj_u", "in_proj_z", "dt_proj")
_CHANNELS = ("conv_w", "conv_b", "dt_bias", "A_log", "D")
_ROWS = ("x_proj", "out_proj")


def _local(fn, p, x, state=None):
    """``fn`` on the block's channel shards (``shard_ctx.channels_local``)."""
    return channels_local(fn, x, {k: p[k] for k in _COLS},
                          {k: p[k] for k in _CHANNELS},
                          {k: p[k] for k in _ROWS}, state)


def mamba_block(cfg: ModelConfig, p, x, *, impl: str = "xla",
                return_state: bool = False):
    """Full mamba mixing block (no residual/norm).  x: (B,S,d) -> (B,S,d).
    With ``return_state`` also returns the streaming state (prefill):
    {"conv": the last W-1 inputs of the conv, "h": the scan's final
    state}.  Under a mesh the block runs on local shards of d_inner."""
    kernel = impl == "pallas" and not return_state

    def body(x, p, state, gather, reduce):
        u_raw = x @ p["in_proj_u"]                          # (B,S,di)
        z = x @ p["in_proj_z"]                              # (B,S,di)
        u = F.silu(_causal_conv(u_raw, p["conv_w"], p["conv_b"]))
        delta, B_ssm, C_ssm = _ssm_inputs(cfg, p, u, reduce)
        if kernel:
            y, h = ops.ssm_scan(u, delta, B_ssm, C_ssm, p["A_log"],
                                p["D"]), None
        else:
            y, h = selective_scan(cfg, p, u, delta, B_ssm, C_ssm)
        out = (y * F.silu(z)) @ p["out_proj"]
        if not return_state:
            return out, None
        W = p["conv_w"].shape[1]
        return out, {"conv": u_raw[:, -(W - 1):, :], "h": h}

    out, state = _local(body, p, x)
    return (out, state) if return_state else out


def mamba_decode_step(cfg: ModelConfig, p, x, state):
    """x: (B,1,d); state: {"conv": (B,W-1,di), "h": (B,di,N)} -> (y, the
    new state)."""
    def body(x, p, state, gather, reduce):
        u = x @ p["in_proj_u"]
        z = x @ p["in_proj_z"]
        u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"],
                                     state["conv"])
        u = F.silu(u)
        delta, B_ssm, C_ssm = _ssm_inputs(cfg, p, u, reduce)
        y, h = selective_scan(cfg, p, u, delta, B_ssm, C_ssm, state["h"])
        y = y * F.silu(z)
        return y @ p["out_proj"], {"conv": conv_state, "h": h}

    return _local(body, p, x, state)
