"""Adagrad (Duchi et al. 2011) — the port of ``repro.optim.adagrad``, the
paper's stochastic baseline.  Unlike the batch optimizers it consumes
*mini-batches* (resampled i.i.d.), which is exactly the data-access
pattern BET avoids; the simulated time model charges it per access
(core/timemodel.py).  Accumulators are float32 whatever the parameters'
dtype."""
from __future__ import annotations

import dataclasses

import torch

from .api import BatchOptimizer, Objective, tree_map


@dataclasses.dataclass(frozen=True)
class Adagrad(BatchOptimizer):
    name: str = "adagrad"
    lr: float = 0.1
    eps: float = 1e-8

    def init(self, params):
        return {"acc": tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), params)}

    def step(self, params, state, objective: Objective, data):
        f0, g = objective.value_and_grad(params, data)
        acc = tree_map(lambda a, gi: a + gi.float() ** 2, state["acc"], g)
        params = tree_map(
            lambda p, gi, a: (p.float() - self.lr * gi.float()
                              / (torch.sqrt(a) + self.eps)).to(p.dtype),
            params, g, acc)
        return params, {"acc": acc}, {"f": f0}
