"""Public wrappers around the port's kernels: dispatch by device.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``ref.py``); a tensor on a CUDA device goes to the hand-written kernel,
or the call raises — there is no fallback from the card to the plain
version.

``CALLS`` counts kernel launches per kernel (reset with ``reset_calls``):
a run on the card proves with it that its main path went through the
kernels.  Calls served by the plain version on the CPU are not counted.
"""
from __future__ import annotations

import collections

from . import linear_grad as _lg
from . import ref as _ref

CALLS: collections.Counter = collections.Counter()


def reset_calls() -> None:
    CALLS.clear()


def linear_forward(X, w):
    # forward margins alone are a plain GEMV; the fused win is in value_grad
    return X @ w


def linear_value_grad(X, y, w, *, loss: str = "squared_hinge"):
    """(Σ loss_i, Xᵀ(ℓ′⊙y)) for X (n, d), y (n,), w (d,) — the kernel on
    the card, the plain version on the CPU."""
    kind = X.device.type
    if kind == "cpu":
        return _ref.linear_value_grad(X, y, w, loss=loss)
    if kind != "cuda":
        raise ValueError(f"linear_value_grad runs on 'cuda' or 'cpu', "
                         f"got {X.device}")
    out = _lg.linear_value_grad(X, y, w, loss=loss)
    CALLS["linear_value_grad"] += 1
    return out
