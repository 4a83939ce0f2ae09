"""AdamW for the LM training path — the port of ``repro.optim.adam``'s
functional update (BET as an outer data schedule around a standard LM
optimizer).

Functional: ``adamw_update`` returns new tensors and never writes into
its arguments, so the two Two-Track tracks can start from one parameter
tree and the race can keep earlier carries as snapshots.  Moments are
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
    """One AdamW step: (new params, new state), the reference's update."""
    t = state["t"] + 1
    m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi.float(), state["m"],
                 grads)
    v = tree_map(lambda vi, gi: b2 * vi + (1 - b2) * gi.float() ** 2,
                 state["v"], grads)
    tf = t.float()
    bc1 = 1 - b1 ** tf
    bc2 = 1 - b2 ** tf

    def upd(p, mi, vi):
        step = lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
        p32 = p.float()
        return (p32 - step - lr * weight_decay * p32).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
