"""Plain PyTorch versions of the port's kernels.

Each is what ``ops`` runs for tensors on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel against on the card (there in
float64).  ``ssm_scan`` is also the function whose autograd gives the
kernel's backward pass, as the reference's custom VJP does.  The oracles
of flash attention and the RG-LRU scan come with their slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ------------------------------------------------------- fused linear grad
def linear_forward(X, w):
    return X @ w


def linear_value_grad(X, y, w, loss: str = "squared_hinge"):
    """Returns (sum loss_i, grad of sum loss_i wrt w) — the paper's convex
    hot spot: Xw -> elementwise loss' -> Xᵀr."""
    m = y * (X @ w)
    if loss == "squared_hinge":
        hinge = torch.clamp(1.0 - m, min=0.0)
        li = hinge * hinge
        dm = -2.0 * hinge
    elif loss == "logistic":
        li = F.softplus(-m)
        dm = -torch.sigmoid(-m)
    else:
        raise ValueError(loss)
    r = dm * y
    return li.sum(), X.T @ r


# --------------------------------------------------------------- ssm scan
def ssm_scan(u, delta, B_ssm, C_ssm, A_log, D):
    """Mamba selective scan, a Python loop over time that mirrors the
    reference oracle step for step.
    u, delta: (B, S, di); B_ssm, C_ssm: (B, S, N); A_log: (di, N); D: (di,).
    Returns y: (B, S, di) in u's dtype.  The carry h is float32 (float64
    when u is float64, for the card's accuracy check)."""
    acc = torch.float64 if u.dtype == torch.float64 else torch.float32
    A = -torch.exp(A_log.to(acc))                              # (di, N)
    Bsz, S, di = u.shape
    h = torch.zeros((Bsz, di, A.shape[-1]), dtype=acc, device=u.device)
    ys = []
    for t in range(S):
        d_t, u_t = delta[:, t], u[:, t]                       # (B, di)
        dA = torch.exp(d_t[..., None].to(acc) * A)             # (B, di, N)
        dBu = (d_t * u_t)[..., None].to(acc) * B_ssm[:, t, None, :].to(acc)
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, C_ssm[:, t].to(acc)))
    y = torch.stack(ys, dim=1)
    return (y + u.to(acc) * D.to(acc)).to(u.dtype)
