"""Mamba-1 block (falcon-mamba-7b [arXiv:2410.05355]) — the port of
``repro.models.mamba``.

``selective_scan`` is the time-sequential recurrence written out in
PyTorch, with a small carried state (B, d_inner, ssm_state).
``mamba_block(impl="pallas")`` routes the scan through ``kernels.ops``
instead: the hand-written Hopper kernel on the card, its plain version on
the CPU.  The impl name is the reference's, so a spec or a test reads the
same in both packages.  Prefill's streaming state and decoding wait for the
serving slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig


def _causal_conv(x, conv_w, conv_b):
    """Depthwise causal conv over time.  x: (B,S,di), conv_w: (di, W)."""
    W = conv_w.shape[1]
    pad = torch.zeros_like(x[:, : W - 1])
    xin = torch.cat([pad, x], dim=1)
    # y[:, t, c] = sum_w xin[:, t+w, c] * conv_w[c, w]
    ys = sum(xin[:, w:w + x.shape[1], :] * conv_w[:, w] for w in range(W))
    return ys + conv_b


def _ssm_inputs(cfg: ModelConfig, p, u):
    """u: (B,S,di) post-conv activations -> (delta, B_ssm, C_ssm).
    delta: (B,S,di); B_ssm/C_ssm: (B,S,state)."""
    proj = u @ p["x_proj"]                                  # (B,S,R+2N)
    R, N = cfg.dt_rank, cfg.ssm_state
    dt, B_ssm, C_ssm = torch.split(proj, [R, N, N], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])    # (B,S,di)
    return delta, B_ssm, C_ssm


def selective_scan(cfg: ModelConfig, p, u, delta, B_ssm, C_ssm):
    """Returns y (B,S,di), from a zero state.  A = -exp(A_log)."""
    A = -torch.exp(p["A_log"].float())                      # (di, N)
    Bsz, S, di = u.shape
    h = torch.zeros((Bsz, di, cfg.ssm_state), dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(S):
        u_t, d_t = u[:, t], delta[:, t]
        b_t, c_t = B_ssm[:, t], C_ssm[:, t]
        dA = torch.exp(d_t[..., None].float() * A)          # (B,di,N)
        dBu = (d_t * u_t)[..., None].float() * b_t[:, None, :].float()
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, c_t.float()).to(u.dtype))
    return (torch.stack(ys, dim=1).float()
            + u.float() * p["D"]).to(u.dtype)               # skip connection


def mamba_block(cfg: ModelConfig, p, x, *, impl: str = "xla"):
    """Full mamba mixing block (no residual/norm).  x: (B,S,d) -> (B,S,d)."""
    z = x @ p["in_proj_z"]                                  # (B,S,di)
    u = F.silu(_causal_conv(x @ p["in_proj_u"], p["conv_w"], p["conv_b"]))
    delta, B_ssm, C_ssm = _ssm_inputs(cfg, p, u)
    if impl == "pallas":
        y = ops.ssm_scan(u, delta, B_ssm, C_ssm, p["A_log"], p["D"])
    else:
        y = selective_scan(cfg, p, u, delta, B_ssm, C_ssm)
    return (y * F.silu(z)) @ p["out_proj"]
