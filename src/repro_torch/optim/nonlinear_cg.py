"""Nonlinear Conjugate Gradient (Fletcher–Reeves 1964) with near-exact line
search — the port of ``repro.optim.nonlinear_cg``, the paper's first inner
optimizer (App. A.1).

The CG memory (previous gradient norm and direction) becomes invalid when
the objective changes from f̂_t to f̂_{t+1}; ``reset_memory`` restarts the
method, exactly as the paper does at every batch expansion.  The restart,
the descent safeguard and the Armijo fallback are ``torch.where`` selects
on the device, so a step never waits on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from .api import (BatchOptimizer, Objective, armijo_line_search,
                  quadratic_exact_step, tree_axpy, tree_dot, tree_scale,
                  tree_zeros_like)


@dataclasses.dataclass(frozen=True)
class NonlinearCG(BatchOptimizer):
    name: str = "cg"
    exact_line_search: bool = True  # exact on (piecewise-)quadratic losses
    max_ls_steps: int = 30

    def init(self, params):
        return {"prev_dir": tree_zeros_like(params),
                # ||g_{k-1}||² ; 0 => restart
                "prev_gg": torch.zeros((), dtype=torch.float32,
                                       device=params.device)}

    def reset_memory(self, state):
        return {**state, "prev_gg": torch.zeros_like(state["prev_gg"]),
                "prev_dir": tree_zeros_like(state["prev_dir"])}

    def step(self, params, state, objective: Objective, data):
        f0, g = objective.value_and_grad(params, data)
        gg = tree_dot(g, g)
        # Fletcher–Reeves beta; restart (beta=0) right after reset
        beta = torch.where(state["prev_gg"] > 0,
                           gg / torch.clamp(state["prev_gg"], min=1e-30), 0.0)
        direction = tree_axpy(beta, state["prev_dir"], tree_scale(g, -1.0))
        # safeguard: if not a descent direction, restart with steepest descent
        descent = tree_dot(g, direction) < 0
        direction = torch.where(descent, direction, tree_scale(g, -1.0))
        if self.exact_line_search:
            alpha = quadratic_exact_step(objective, params, data, direction, g)
            f_new = objective(tree_axpy(alpha, direction, params), data)
            # fall back to Armijo if the quadratic model overstepped: both
            # are computed, one is selected
            bad = f_new > f0
            alpha_b, f_b, _ = armijo_line_search(
                objective, params, data, direction, g, f0=f0,
                alpha0=1.0, max_steps=self.max_ls_steps)
            alpha = torch.where(bad, alpha_b, alpha)
            f_new = torch.where(bad, f_b, f_new)
        else:
            alpha, f_new, _ = armijo_line_search(
                objective, params, data, direction, g, f0=f0,
                alpha0=1.0, max_steps=self.max_ls_steps)
        new_params = tree_axpy(alpha, direction, params)
        new_state = {"prev_dir": direction, "prev_gg": gg}
        return new_params, new_state, {"f": f_new, "alpha": alpha,
                                       "beta": beta}
