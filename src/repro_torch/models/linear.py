"""Paper-faithful convex model: regularized linear prediction (Eq. 1).

    f̂(w) = (1/N) Σ ℓ(⟨w, x_i⟩, y_i) + (λ/2)‖w‖²

Losses: squared hinge (the paper's §5 experiments) and logistic (§5.2).
Both make f̂ λ-strongly convex, the setting of Theorem 4.1.

The objective keeps the reference's ``objective(w, data) -> scalar``
contract and adds what the reference got from autodiff, in closed form:
``value_and_grad`` through the fused ``linear_value_grad`` kernel (the
Hopper kernel on the card, its plain version on the CPU), ``hvp``,
Xᵀ(ℓ″⊙Xv)/n + λv, in place of forward-over-reverse, and
``example_grads``, the per-example gradients of the variance tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from ..kernels import ops


def squared_hinge(margin: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - margin, min=0.0) ** 2


def logistic(margin: torch.Tensor) -> torch.Tensor:
    return F.softplus(-margin)


def _squared_hinge_curvature(margin):
    # d²/dm² max(0, 1 - m)² = 2·1[m < 1]  (y² = 1)
    return 2.0 * (margin < 1.0).to(margin.dtype)


def _logistic_curvature(margin):
    # d²/dm² softplus(-m) = σ(m)σ(-m)
    return torch.sigmoid(margin) * torch.sigmoid(-margin)


def _squared_hinge_slope(margin):
    # d/dm max(0, 1 - m)² = -2·max(0, 1 - m)
    return -2.0 * torch.clamp(1.0 - margin, min=0.0)


def _logistic_slope(margin):
    # d/dm softplus(-m) = -σ(-m)
    return -torch.sigmoid(-margin)


LOSSES: dict[str, Callable] = {"squared_hinge": squared_hinge,
                               "logistic": logistic}
_SLOPE = {"squared_hinge": _squared_hinge_slope, "logistic": _logistic_slope}
_CURVATURE = {"squared_hinge": _squared_hinge_curvature,
              "logistic": _logistic_curvature}


def init_params(d: int, *, device="cuda") -> torch.Tensor:
    """Paper: w0 = 0."""
    return torch.zeros((d,), dtype=torch.float32, device=device)


def make_example_losses(loss: str = "squared_hinge"):
    """Returns example_losses(w, (X, y)) -> (n,) per-example losses — the
    unregularized summands of Eq. 1.  ``w`` may also be a (d, K) stack of
    K parameter vectors, giving (n, K)."""
    loss_fn = LOSSES[loss]

    def example_losses(w, data):
        X, y = data
        m = ops.linear_forward(X, w)
        margins = (y[:, None] if m.dim() == 2 else y) * m
        return loss_fn(margins)

    return example_losses


@dataclasses.dataclass(frozen=True, eq=False)
class LinearObjective:
    """f̂(w) on a window ``data = (X, y)``; ``objective(w, data)`` is the
    scalar value.  Identity-hashed, so stage caches may key on it."""
    loss: str = "squared_hinge"
    lam: float = 1e-4

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; available: "
                             f"{sorted(LOSSES)}")

    def __call__(self, w, data):
        return torch.mean(make_example_losses(self.loss)(w, data)) \
            + 0.5 * self.lam * torch.sum(w * w)

    def values(self, W, data):
        """f̂ at each column of a (d, K) stack W, as a (K,) tensor — one
        GEMM for all K points (the batched Armijo search)."""
        return torch.mean(make_example_losses(self.loss)(W, data), dim=0) \
            + 0.5 * self.lam * torch.sum(W * W, dim=0)

    def value_and_grad(self, w, data):
        """(f̂(w), ∇f̂(w)) from one fused pass over X."""
        X, y = data
        n = X.shape[0]
        L, g = ops.linear_value_grad(X, y, w, loss=self.loss)
        return L / n + 0.5 * self.lam * torch.sum(w * w), g / n + self.lam * w

    def hvp_operator(self, w, data) -> Callable:
        """v -> ∇²f̂(w) v on ``data``, with the curvature weights ℓ″(m)
        computed once for every product at this ``w``."""
        X, y = data
        n = X.shape[0]
        curv = _CURVATURE[self.loss](y * ops.linear_forward(X, w))
        return lambda v: X.T @ (curv * (X @ v)) / n + self.lam * v

    def hvp(self, w, data, v):
        return self.hvp_operator(w, data)(v)

    def example_grads(self, w, data):
        """The gradient of f̂ on each one-row window (x_i, y_i), as a
        (n, d) tensor: ℓ′(mᵢ)·yᵢ·xᵢ + λw (the reference vmaps autodiff)."""
        X, y = data
        slope = _SLOPE[self.loss](y * ops.linear_forward(X, w))
        return (slope * y)[:, None] * X + self.lam * w


def make_objective(loss: str = "squared_hinge",
                   lam: float = 1e-4) -> LinearObjective:
    """Returns objective(w, (X, y)) -> scalar, with ``value_and_grad`` and
    ``hvp`` beside it."""
    return LinearObjective(loss, lam)


def accuracy(w, X, y) -> torch.Tensor:
    pred = torch.sign(X @ w)
    pred = torch.where(pred == 0, 1.0, pred)
    return torch.mean((pred == y).to(torch.float32))


def solve_reference(objective, w0, data, *, steps: int = 200):
    """High-precision minimizer ŵ* for RFVD reporting (Eq. 6), via
    Newton-CG on the full dataset."""
    from ..optim import NewtonCG
    opt = NewtonCG(hessian_fraction=1.0, cg_steps=25)
    state = opt.init(w0)
    w = w0
    for _ in range(steps):
        w, state, _ = opt.step(w, state, objective, data)
    return w, objective(w, data)


def rfvd(objective, w, data, f_star) -> torch.Tensor:
    """log Relative Functional Value Difference (Eq. 6)."""
    return torch.log10(torch.clamp(
        (objective(w, data) - f_star) / abs(f_star), min=1e-16))
