"""The step functions — the port of ``repro.launch.steps``: the LM train
step and ``init_opt_state``, and the serving pair ``make_prefill_step`` /
``make_serve_step``.

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


def make_prefill_step(cfg: ModelConfig, *, impl: str = "xla",
                      cache_len: int | None = None):
    def prefill_fn(params, batch):
        return T.prefill_step(cfg, params, batch, impl=impl,
                              cache_len=cache_len)
    return prefill_fn


def make_serve_step(cfg: ModelConfig):
    """One decode step; it consumes the cache it is given (see
    ``models.transformer.decode_step``)."""
    def serve_step(params, cache, batch):
        return T.decode_step(cfg, params, cache, batch)
    return serve_step
