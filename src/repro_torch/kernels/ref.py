"""Plain PyTorch versions of the port's kernels (float32).

``linear_value_grad`` is what ``ops.linear_value_grad`` runs for tensors on
the CPU, and what ``chip_smoke.py`` holds the CUDA kernel against on the
card.  The oracles of the LM kernels (flash attention, the scans) come
with their slices.
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
