"""The step functions — the port of ``repro.launch.steps``: the LM train
step and ``init_opt_state``, and the serving pair ``make_prefill_step`` /
``make_serve_step``.

The reference differentiates the loss with ``jax.value_and_grad`` inside
``jit``; here autograd runs eagerly on detached copies of the parameter
leaves, and the AdamW update returns a new tree (nothing is written in
place, see ``optim/adam.py``).  ``remat`` (default on, as in the
reference) rematerializes the model's layers in the backward pass
(``models/transformer.py``).

Under a mesh the train step takes DTensor parameters (``launch/
shardings.py``), a DTensor batch and a DTensor optimizer state.  The
parameters are all-gathered over the FSDP axes for the forward pass (the
weight all-gathers GSPMD inserts for the reference), plain tensors the
model makes (positions, masks) count as replicated, and the operations
DTensor has no strategy for run replicated
(``shardings.replicate_fallback``, each recorded in ``notes``).  Each
gradient comes back ``Partial`` over the batch's axes and is
redistributed to its parameter's placements — a reduce-scatter over the
FSDP axes, an all-reduce where the parameter is replicated — so AdamW
updates local shards.  The metrics come back as plain tensors."""
from __future__ import annotations

import contextlib

import torch

from ..models import transformer as T
from ..models.common import ModelConfig
from ..optim.adam import adamw_init, adamw_update
from ..optim.api import tree_leaves, tree_map


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def mesh_context(params, notes: list | None = None):
    """Around a step on DTensor parameters: plain tensors count as
    replicated, and the ops DTensor has no strategy for run replicated
    (recorded in ``notes``).  Nothing on plain parameters."""
    if not any(_is_dtensor(x) for x in tree_leaves(params)):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    from .shardings import replicate_fallback
    with implicit_replication(), replicate_fallback(notes):
        yield


def _gathered(x, axes: tuple):
    """``x`` all-gathered over the mesh axes ``axes`` (the FSDP axes): the
    layout a layer computes with.  Its backward reduce-scatters the
    gradient back over them."""
    if not axes or not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in axes else p
               for n, p in zip(names, x.placements))
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _to_param_layout(g, p):
    """A gradient in its parameter's placements."""
    if _is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(x):
    return x.full_tensor() if _is_dtensor(x) else x


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                    weight_decay: float = 0.1, impl: str = "xla",
                    remat: bool = True, notes: list | None = None,
                    gather_axes: tuple = ()):
    """``notes`` collects the ops a mesh step ran replicated;
    ``gather_axes`` are the FSDP mesh axes: each parameter is all-gathered
    over them before the forward pass (ZeRO-3), so a layer's products
    contract whole weights on its batch shard."""
    gather_axes = tuple(gather_axes)

    def train_step(params, opt_state, batch):
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        with mesh_context(p, notes):
            with torch.enable_grad():
                used = tree_map(lambda x: _gathered(x, gather_axes), p)
                loss, metrics = T.loss_fn(cfg, used, batch, impl=impl,
                                          remat=remat)
                flat = torch.autograd.grad(loss, leaves)
            flat = [_to_param_layout(g, x) for g, x in zip(flat, leaves)]
            it = iter(flat)
            grads = tree_map(lambda _: next(it), p)
            params, opt_state = adamw_update(params, grads, opt_state,
                                             lr=lr,
                                             weight_decay=weight_decay)
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in flat))
        metrics = {k: _plain(v.detach()) for k, v in metrics.items()}
        metrics.update(loss=_plain(loss.detach()), grad_norm=_plain(gnorm))
        return params, opt_state, metrics

    return train_step


def init_opt_state(params):
    return adamw_init(params)


def opt_state_specs(params_shape):
    """The AdamW state of an abstract parameter tree, as meta tensors (the
    reference's ``ShapeDtypeStruct``s from ``jax.eval_shape``)."""
    return adamw_init(tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        params_shape))


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
