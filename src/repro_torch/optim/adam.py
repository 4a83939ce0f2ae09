"""AdamW for the LM training path — the port of ``repro.optim.adam``'s
functional update (BET as an outer data schedule around a standard LM
optimizer).

Functional: ``adamw_update`` returns new tensors and never writes into
its arguments, so the two Two-Track tracks can start from one parameter
tree and the race can keep a frozen slow carry beside the new one.  Moments are
float32 whatever the parameters' dtype; ``t`` is a device tensor, so a
step never waits on the host.
"""
from __future__ import annotations

import torch

from .api import tree_leaves, tree_map


def adamw_init(params):
    z = lambda: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                         params)
    return {"m": z(), "v": z(),
            "t": torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device)}


def adamw_update(params, grads, state, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.0):
    """One AdamW step: (new params, new state), the reference's update
    operation for operation.  Where the reference's expression would make
    a new temporary, the update writes into one it made itself (the same
    operations on the same values, so the same rounding): a leaf's update
    holds fewer float32 copies of the leaf at once, which bounds the peak
    at the largest leaf (the embedding)."""
    t = state["t"] + 1
    tf = t.float()
    bc1 = 1 - b1 ** tf
    bc2 = 1 - b2 ** tf

    def first(mi, gi):              # b1·m + (1 - b1)·g
        return (gi.float() * (1 - b1)).add_(b1 * mi)

    def second(vi, gi):             # b2·v + (1 - b2)·g²
        return (gi.float() ** 2).mul_(1 - b2).add_(b2 * vi)

    def upd(p, mi, vi):             # p - lr·m̂/(√v̂ + eps) - lr·wd·p
        step = (mi / bc1).mul_(lr)
        step.div_(torch.sqrt_(vi / bc2).add_(eps))
        p32 = p.float()
        new = p32 - step
        del step
        return new.sub_(lr * weight_decay * p32).to(p.dtype)

    m = tree_map(first, state["m"], grads)
    v = tree_map(second, state["v"], grads)
    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
