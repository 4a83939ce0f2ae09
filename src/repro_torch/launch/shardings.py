"""Sharding policies — the port of ``repro.launch.shardings``: parameter,
optimizer-state, batch and cache layouts for a mesh, as DTensor
placements over a ``DeviceMesh``.

Baseline layouts (the reference's):
  * ``tp``      — Megatron tensor parallelism over the ``model`` axis only
                  (serving: no optimizer state, weights stay resident).
  * ``fsdp_tp`` — tp + fully sharded (ZeRO-3) over the data axes
                  (training: parameters, gradients and Adam moments all
                  sharded; the per-layer weight all-gathers come from
                  DTensor's redistribution where GSPMD inserts them).
  * ``fsdp``    — ZeRO-3 over the whole mesh, no tensor parallelism.

The rules give, per leaf, the reference's ``PartitionSpec`` as a tuple:
one entry per tensor dim, each ``None``, one axis name or a tuple of axis
names.  Any dimension that does not divide evenly over its axes is
replicated.  ``to_placements`` turns a spec into one placement per mesh
dim: a tensor dim split over ("pod", "data") is ``Shard(d)`` on both
mesh dims, which DTensor splits in mesh-dim order — JAX's row-major
order when the axes are named in mesh order, as the rules name them.

``make_activation_sharder`` is the ``+act``/``+attnb``/``+seq`` hook
(``models/shard_ctx.py``): it redistributes a DTensor activation where
the reference calls ``with_sharding_constraint``.

``replicate_fallback`` covers the operations DTensor refuses on the
layouts the models give them: their DTensor inputs are gathered to
``Replicate()`` over as few mesh dims as make them run — GSPMD's
replicated layout at that op — and each use is recorded with the
model's file:line.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.common import ModelConfig
from .mesh import axis_names, axis_size, dp_axes

# (tp_dim, fsdp_dim) per parameter name, indexed on the *trailing* dims
# (i.e. excluding the leading stacked-layer axis for stack params).
_RULES: dict = {
    "embed": (0, 1), "lm_head": (1, 0),
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0), "wo": (0, 1),
    "w_gate": (1, 0), "w_up": (1, 0), "w_down": (0, 1),
    "shared_w_gate": (1, 0), "shared_w_up": (1, 0), "shared_w_down": (0, 1),
    "router": (None, None),
    "in_proj_u": (1, 0), "in_proj_z": (1, 0), "out_proj": (0, 1),
    "conv_w": (0, None), "conv_b": (0, None),
    "x_proj": (0, None), "dt_proj": (1, 0), "dt_bias": (0, None),
    "A_log": (0, None), "D": (0, None),
    "in_proj_rnn": (1, 0), "in_proj_gate": (1, 0),
    "w_a": (1, 0), "w_x": (1, 0), "lambda_p": (0, None),
    "norm1": (None, None), "norm2": (None, None), "final_norm": (None, None),
    "q_norm": (None, None), "k_norm": (None, None),
}

# MoE expert stacks carry a leading expert dim (E, d, f)/(E, f, d): experts
# shard over model, the matrix dims over fsdp.
_MOE_RULES = {"w_gate": (0, 1), "w_up": (0, 1), "w_down": (0, 2)}


def _spec(entries) -> tuple:
    """A spec tuple with a one-axis tuple written as its axis name, as
    ``PartitionSpec`` normalizes it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _maybe(axes, dim_size: int, mesh):
    """Return ``axes`` if dim divides evenly over them, else None."""
    if axes is None:
        return None
    if dim_size % axis_size(mesh, axes) == 0:
        return axes
    return None


def _leaf_spec(name: str, shape, is_stack: bool, is_moe_expert: bool,
               mesh, policy: str) -> tuple:
    ndim = len(shape)
    off = 1 if is_stack else 0
    spec = [None] * ndim
    if policy == "fsdp":
        # pure ZeRO-3: no tensor parallelism; weights sharded over the whole
        # mesh, batch over the whole mesh
        fsdp = tuple(axis_names(mesh))
    else:
        fsdp = dp_axes(mesh) if policy == "fsdp_tp" else None
    if is_moe_expert:
        tp_d, fs_d = _MOE_RULES[name]
        # MoE rules index dims right after the stack axis: (E, d, f)
        to_real = lambda r: off + r
    elif name in _RULES:
        tp_d, fs_d = _RULES[name]
        # dense rules index the trailing matrix dims (or the single vector dim)
        base = ndim - (2 if ndim - off >= 2 else 1)
        to_real = lambda r: base + r
    else:
        return _spec(spec)
    if tp_d is not None and policy != "fsdp":
        real = to_real(tp_d)
        if 0 <= real < ndim:
            spec[real] = _maybe("model", shape[real], mesh)
    if fsdp and fs_d is not None:
        real = to_real(fs_d)
        if 0 <= real < ndim and spec[real] is None:
            spec[real] = _maybe(fsdp, shape[real], mesh)
    return _spec(spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs_tree(cfg: ModelConfig, params_shape: Any, mesh,
                     policy: str = "fsdp_tp") -> dict:
    """The spec tree mirroring ``params_shape`` (a tree of tensors, meta
    or real: only the shapes are read)."""
    def visit(path, leaf):
        stack = any(str(k).startswith("stack_") for k in path)
        moe_exp = "stack_moe" in path
        name = str(path[-1])
        is_expert = moe_exp and name in _MOE_RULES
        return _leaf_spec(name, tuple(leaf.shape), stack, is_expert, mesh,
                          policy)

    return _map_with_path(visit, params_shape)


# ------------------------------------------------------------- batch / cache
def batch_partition(cfg: ModelConfig, batch_shape: Any, mesh, dp=None):
    """Specs for training / prefill / decode batches."""
    dp = dp if dp is not None else dp_axes(mesh)

    def visit(path, leaf):
        name = str(path[-1])
        if name in ("tokens", "labels"):
            return _spec((_maybe(dp, leaf.shape[0], mesh), None))
        if name == "embeds":
            return _spec((_maybe(dp, leaf.shape[0], mesh), None, None))
        if name == "positions":
            return _spec((None, _maybe(dp, leaf.shape[1], mesh), None))
        return ()

    return _map_with_path(visit, batch_shape)


def cache_partition(cfg: ModelConfig, cache_shape: Any, mesh):
    """Decode-cache specs: batch over data axes, the long axis (KV sequence /
    d_inner / lru width) over the model axis."""
    dp = dp_axes(mesh)

    def visit(path, leaf):
        name = str(path[-1])
        shape = tuple(leaf.shape)
        b_ax = _maybe(dp, shape[1], mesh)
        if name in ("k", "v"):
            # (L, B, S, KV, hd): shard cache sequence over model
            return _spec((None, b_ax, _maybe("model", shape[2], mesh),
                          None, None))
        if name == "conv":
            # (L, B, W-1, di|w)
            return _spec((None, b_ax, None, _maybe("model", shape[3], mesh)))
        if name == "h":
            if len(shape) == 4:   # ssm (L, B, di, N)
                return _spec((None, b_ax, _maybe("model", shape[2], mesh),
                              None))
            # rec (L, B, w)
            return _spec((None, b_ax, _maybe("model", shape[2], mesh)))
        return ()

    return _map_with_path(visit, cache_shape)


# ------------------------------------------------------------ to DTensor
def to_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim for a spec tuple: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` is split over, ``Replicate()`` on the
    others.  Axes split over together must be named in mesh order (JAX's
    row-major order is DTensor's mesh-dim order then)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"shards two tensor dims")
            out[i] = Shard(d)
    return tuple(out)


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each tensor leaf as a DTensor laid out by its spec.  Every rank
    passes the same whole tensor (a seeded init, or a fake or meta
    tensor) and keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, to_placements(specs, mesh),
                             src_data_rank=None)


# ------------------------------------------------------------- activations
def activation_spec(mesh, variants=(), dp=None):
    """The spec the activation sharder pins a ``(shape, kind)`` to, or
    None where it leaves the tensor alone (the reference's
    ``make_activation_sharder``, rule for rule)."""
    dp = dp if dp is not None else dp_axes(mesh)
    all_ax = tuple(axis_names(mesh))

    def spec_of(shape, kind: str):
        ndim = len(shape)
        if ndim < 2:
            return None
        b_ax = _maybe(dp, shape[0], mesh)
        if kind == "act_btd":
            # "+seq" (Megatron sequence parallelism): layer-boundary
            # activations shard their sequence dim over the model axis
            seq_ax = None
            if "seq" in variants and ndim >= 3 and b_ax is not None \
                    and "model" not in tuple(b_ax):
                seq_ax = _maybe("model", shape[1], mesh)
            return _spec((b_ax, seq_ax, *([None] * (ndim - 2))))
        if kind == "logits":
            v_ax = _maybe("model", shape[-1], mesh)
            if b_ax and "model" in tuple(b_ax):
                v_ax = None                 # pure-FSDP: batch owns the mesh
            return _spec((b_ax, *([None] * (ndim - 2)), v_ax))
        if kind in ("attn_batch", "act_btd_full") and "attnb" in variants:
            full = _maybe(all_ax, shape[0], mesh)
            if full is None:
                return None
            return _spec((full, *([None] * (ndim - 1))))
        return None

    return spec_of


def make_activation_sharder(mesh, variants=(), dp=None):
    """``+act``: pin batch sharding at layer boundaries and in the chunked
    loss.  ``+attnb``: reshard attention inputs so batch covers the whole
    mesh (data × model) for the attention einsums.  ``+seq``: layer
    boundaries also shard the sequence over the model axis.  A DTensor is
    redistributed to the chosen placements; a plain tensor is left
    alone."""
    spec_of = activation_spec(mesh, variants, dp)

    def f(x, kind: str):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        spec = spec_of(tuple(x.shape), kind)
        if spec is None:
            return x
        return x.redistribute(x.device_mesh, to_placements(spec, mesh))

    return f


# ------------------------------------------------------ replicated fallback
_MODELS_DIR = os.path.join("repro_torch", "models")


def _model_site() -> str:
    """file:line of the innermost frame in the port's models (the op's
    origin; the head-layout helpers of ``shard_ctx.py`` name the model
    line that called them), else of the innermost frame in
    ``repro_torch``."""
    f = sys._getframe(1)
    fallback = "?"
    while f is not None:
        fn = f.f_code.co_filename
        if _MODELS_DIR in fn and not fn.endswith("shard_ctx.py"):
            return f"{fn[fn.index('repro_torch'):]}:{f.f_lineno}"
        if fallback == "?" and "repro_torch" in fn \
                and not fn.endswith("shardings.py"):
            fallback = f"{fn[fn.index('repro_torch'):]}:{f.f_lineno}"
        f = f.f_back
    return fallback


def _fallback_mode(notes):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import (DTensorSpec,
                                                         TensorMeta)
    from torch.utils._pytree import tree_leaves, tree_map

    def record(func, reason: str) -> None:
        node = torch._C._current_autograd_node()
        site = f"backward:{node.name()}" if node is not None \
            else _model_site()
        if notes is not None and not any(
                n["op"] == str(func) and n["site"] == site for n in notes):
            notes.append({"op": str(func), "site": site,
                          "layout": "Replicate", "reason": reason})

    def gathered(args, kwargs, mesh_dims):
        """The DTensor inputs replicated over ``mesh_dims``."""
        def one(a):
            if not isinstance(a, DTensor):
                return a
            pl = tuple(Replicate() if i in mesh_dims else p
                       for i, p in enumerate(a.placements))
            return a if pl == tuple(a.placements) else \
                a.redistribute(a.device_mesh, pl)
        return tree_map(one, args), tree_map(one, kwargs)

    def replicated(func, args, kwargs, mesh):
        whole = lambda a: a.full_tensor() if isinstance(a, DTensor) else a
        out = func(*tree_map(whole, args), **tree_map(whole, kwargs))
        rep = (Replicate(),) * mesh.ndim

        def wrap(t):
            if not isinstance(t, torch.Tensor):
                return t
            spec = DTensorSpec(mesh, rep, tensor_meta=TensorMeta(
                t.shape, t.stride(), t.dtype))
            return DTensor(t, spec, requires_grad=False)

        return tree_map(wrap, out)

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not any(issubclass(t, DTensor) for t in types):
                return func(*args, **kwargs)
            if func is torch.ops.aten.gather.default:
                args, kwargs = self._pre_gather(func, args, kwargs)
            try:
                return func(*args, **kwargs)
            except Exception as exc:    # noqa: BLE001 — recorded below
                if func._schema.is_mutable:
                    raise           # a replica cannot be written back
                reason = f"{type(exc).__name__}: " \
                    f"{str(exc).splitlines()[0][:160]}"
            mesh = next(a.device_mesh for a in tree_leaves((args, kwargs))
                        if isinstance(a, DTensor))
            # the least replication that runs: the last mesh dim, the
            # last two, ..., then every input whole
            for k in range(1, mesh.ndim + 1):
                dims = set(range(mesh.ndim - k, mesh.ndim))
                a2, kw2 = gathered(args, kwargs, dims)
                try:
                    out = func(*a2, **kw2)
                except Exception:       # noqa: BLE001 — more replicas
                    continue
                record(func, f"{reason} (replicated over mesh dims "
                             f"{sorted(dims)})")
                return out
            record(func, reason)
            return replicated(func, args, kwargs, mesh)

        def _pre_gather(self, func, args, kwargs):
            """``gather(input, dim, index)`` with ``input`` replicated
            over the mesh dims that shard ``dim`` or hold partial sums
            (its other shards kept).  Over a vocabulary-sharded or
            partial dim (the loss's gold logit) DTensor takes its
            masked-partial path, which fails later, in the reduction of
            the output, on a 3-D index (IndexError in ``_MaskPartial``,
            torch 2.13): too late to fall back, so this layout is chosen
            ahead."""
            x, dim = args[0], args[1]
            if not isinstance(x, DTensor):
                return args, kwargs
            dim = dim % x.ndim
            dims = {i for i, p in enumerate(x.placements)  # Shard, Partial
                    if getattr(p, "dim", None) == dim or p.is_partial()}
            if not dims:
                return args, kwargs
            record(func, "gather over a sharded dim (replicated over mesh "
                         f"dims {sorted(dims)})")
            return gathered(args, kwargs, dims)

    return Mode()


@contextlib.contextmanager
def replicate_fallback(notes: list | None = None):
    """A dispatch mode over DTensor operations: each runs as DTensor runs
    it, and where DTensor refuses its layout (no sharding strategy, a
    redistribution it does not support — which ops depends on the torch
    version: a view splitting a sharded dim into factors the mesh does
    not divide, the embedding's backward ``index_put`` under torch 2.11,
    ...) it runs with its DTensor inputs replicated over as few mesh dims
    as make it run, the last first, or whole — GSPMD's replicated layout
    at that op.  ``aten.gather`` gets its layout chosen ahead.  Each
    (op, file:line, reason) is appended to ``notes`` once; inside
    autograd's backward the site is the backward node's name.  An
    in-place op is never replicated: its error propagates."""
    with _fallback_mode(notes):
        yield notes
