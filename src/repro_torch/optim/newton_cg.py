"""Sub-sampled Newton-CG (Byrd et al. 2011) — the paper's main inner
optimizer (§5).

Per step: full-window gradient (the fused ``linear_value_grad`` kernel);
Hessian restricted to a fraction R of the window; ``cg_steps`` (= R^{-1} =
10 in the paper) linear-CG iterations on H d = -g via Hessian-vector
products; Armijo step along d.

The Hessian subsample is the *prefix*-rolling sub-window of the window
rather than an i.i.d. resample — this preserves BET's no-resampling
property; the paper reports robustness to the subsample choice (App. A.2).
The step counter ``t`` that rolls it is a 0-d int32 tensor on the
parameters' device, as in the reference: the sub-window's offset is made
on the device, so a step never waits on the host and a captured step
(the race's WHILE graph) reads the current count at every replay.
"""
from __future__ import annotations

import dataclasses

import torch

from .api import (BatchOptimizer, Objective, armijo_line_search, tree_axpy,
                  tree_dot, tree_scale, tree_zeros_like)
from ..data.device_window import rolling_subwindow


@dataclasses.dataclass(frozen=True)
class NewtonCG(BatchOptimizer):
    name: str = "newton_cg"
    hessian_fraction: float = 0.1   # R
    cg_steps: int = 10              # R^{-1}
    max_ls_steps: int = 30

    def init(self, params):
        return {"t": torch.zeros((), dtype=torch.int32,
                                 device=params.device)}

    def _subsample(self, data, t):
        return rolling_subwindow(data, self.hessian_fraction, t)

    def step(self, params, state, objective: Objective, data):
        f0, g = objective.value_and_grad(params, data)
        t = state["t"]
        hvp = objective.hvp_operator(params, self._subsample(data, t))

        # linear CG on H d = -g, d0 = 0
        r = g                       # residual = H d - (-g) = g at d=0
        d = tree_zeros_like(params)
        p = tree_scale(g, -1.0)
        rs = tree_dot(r, r)
        for _ in range(self.cg_steps):
            hp = hvp(p)
            php = tree_dot(p, hp)
            alpha = torch.where(php > 1e-30, rs / torch.clamp(php, min=1e-30),
                                0.0)
            d = tree_axpy(alpha, p, d)
            r = tree_axpy(alpha, hp, r)
            rs_new = tree_dot(r, r)
            beta = torch.where(rs > 1e-30, rs_new / torch.clamp(rs, min=1e-30),
                               0.0)
            p = tree_axpy(beta, p, tree_scale(r, -1.0))
            rs = rs_new

        # descent safeguard
        direction = torch.where(tree_dot(d, g) < 0, d, -g)
        alpha, f_new, _ = armijo_line_search(
            objective, params, data, direction, g, f0=f0,
            alpha0=1.0, max_steps=self.max_ls_steps)
        new_params = tree_axpy(alpha, direction, params)
        return new_params, {"t": t + 1}, {"f": f_new, "alpha": alpha}
