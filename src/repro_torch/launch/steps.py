"""The LM train step — the port of ``repro.launch.steps``'s
``make_train_step`` and ``init_opt_state``.

The reference differentiates the loss with ``jax.value_and_grad`` inside
``jit``; here autograd runs eagerly on detached copies of the parameter
leaves, and the AdamW update returns a new tree (nothing is written in
place, see ``optim/adam.py``).  ``remat`` (default on, as in the
reference) rematerializes the model's layers in the backward pass
(``models/transformer.py``)."""
from __future__ import annotations

import torch

from ..models import transformer as T
from ..models.common import ModelConfig
from ..optim.adam import adamw_init, adamw_update
from ..optim.api import tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                    weight_decay: float = 0.1, impl: str = "xla",
                    remat: bool = True):
    def train_step(params, opt_state, batch):
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = T.loss_fn(cfg, p, batch, impl=impl, remat=remat)
            flat = torch.autograd.grad(loss, tree_leaves(p))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), p)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                         weight_decay=weight_decay)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in flat))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step


def init_opt_state(params):
    return adamw_init(params)
