"""Batch gradient descent with Armijo backtracking (a *linear optimizer*:
linear convergence on strongly-convex objectives, O(window) per step)."""
from __future__ import annotations

import dataclasses

import torch

from .api import BatchOptimizer, Objective, armijo_line_search, tree_axpy, tree_scale


class GDState(dict):
    """The reference's name for gradient descent's state (which its
    optimizer, like this one, keeps as a plain dict)."""


@dataclasses.dataclass(frozen=True)
class GradientDescent(BatchOptimizer):
    name: str = "gd"
    alpha0: float = 1.0
    max_ls_steps: int = 30

    def init(self, params):
        return {"alpha_prev": torch.full((), self.alpha0, dtype=torch.float32,
                                         device=params.device)}

    def step(self, params, state, objective: Objective, data):
        f0, g = objective.value_and_grad(params, data)
        direction = tree_scale(g, -1.0)
        alpha, f_new, _ = armijo_line_search(
            objective, params, data, direction, g, f0=f0,
            alpha0=1.0, max_steps=self.max_ls_steps)
        new_params = tree_axpy(alpha, direction, params)
        return new_params, {"alpha_prev": alpha}, {"f": f_new, "alpha": alpha}
