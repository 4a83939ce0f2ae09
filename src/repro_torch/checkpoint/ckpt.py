"""Checkpointing: flat-key ``.npz`` tree save/restore plus BET schedule
state — the port of ``repro.checkpoint.ckpt``, in its exact format.

A leaf lands in the ``.npz`` under ``<name>/<path>``, the path being the
leaf's dict keys and sequence indices joined by ``/`` (a bare tensor's
path is empty: the convex ``w`` is ``params/``).  A bfloat16 leaf is
saved as its ``uint16`` bits and tagged ``"bfloat16"`` in the ``.json``
sidecar, which also holds each leaf's dtype and the scalar metadata.  The
port's parameter and optimizer-state trees carry the reference's names,
so a checkpoint written by either package loads in the other.

Leaves are tensors (saved from any device), numpy arrays, or Python
scalars (host-side optimizer state such as Newton-CG's step counter); a
load restores each into the type, dtype and device of its ``like``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import numpy as np
import torch


def _items(tree: Any, path: tuple = ()):
    """(path, leaf) for every leaf of nested dicts, lists and tuples;
    ``None`` is an empty subtree, as in a JAX pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save_state(path, trees: dict, *, meta: dict | None = None):
    """Save named trees plus JSON metadata.

    ``trees`` maps a name (e.g. ``"params"``, ``"opt"``) to a tree; each
    leaf lands in the ``.npz`` under ``<name>/<flat key>``.  A stage
    checkpoint (elastic/checkpoint.py) stores the whole runtime state this
    way: array state in ``trees``, scalar state (window cursor, clock,
    meter counters, trace points) in ``meta``."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    packed, dtypes = {}, {}
    for name, tree in trees.items():
        if tree is None:
            continue
        for p, leaf in _items(tree):
            key = f"{name}/{_key(p)}"
            packed[key] = _to_numpy(leaf)
            bf16 = isinstance(leaf, torch.Tensor) and \
                leaf.dtype == torch.bfloat16
            dtypes[key] = "bfloat16" if bf16 else str(packed[key].dtype)
    np.savez(path.with_suffix(".npz"), **packed)
    sidecar = {"dtypes": dtypes, "meta": meta or {}}
    path.with_suffix(".json").write_text(json.dumps(sidecar, indent=2))


def _restore_leaf(arr: np.ndarray, dtype: str, like, key: str):
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(t.shape)}, expected {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def _rebuild(like, path: tuple, leaf_at):
    if isinstance(like, dict):
        return {k: _rebuild(v, path + (k,), leaf_at) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, path + (i,), leaf_at)
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaf_at(path, like)


def load_state(path, likes: dict):
    """Restore named trees into the structures of ``likes`` (shapes must
    match); a ``None`` like skips that tree.  Returns (trees, meta)."""
    path = pathlib.Path(path)
    sidecar = json.loads(path.with_suffix(".json").read_text())
    dtypes = sidecar["dtypes"]
    with np.load(path.with_suffix(".npz")) as data:
        def tree(name, like):
            def leaf_at(p, leaf_like):
                key = f"{name}/{_key(p)}"
                return _restore_leaf(data[key], dtypes[key], leaf_like, key)
            return _rebuild(like, (), leaf_at)
        trees = {name: tree(name, like) if like is not None else None
                 for name, like in likes.items()}
    return trees, sidecar["meta"]


def save_checkpoint(path, params, opt_state=None, *, meta: dict | None = None):
    save_state(path, {"params": params, "opt": opt_state}, meta=meta)


def load_checkpoint(path, params_like, opt_like=None):
    """Restores into the structure of ``params_like`` (shapes must match)."""
    trees, meta = load_state(path, {"params": params_like, "opt": opt_like})
    return trees["params"], trees["opt"], meta


@dataclasses.dataclass
class CheckpointManager:
    """Rolling checkpoints with BET schedule state."""
    directory: str
    keep: int = 3

    def save(self, step: int, params, opt_state=None, *, stage: int = 0,
             window: int = 0, sim_time: float = 0.0, accesses: int = 0):
        d = pathlib.Path(self.directory)
        save_checkpoint(d / f"ckpt_{step:08d}", params, opt_state,
                        meta={"step": step, "stage": stage, "window": window,
                              "sim_time": sim_time, "accesses": accesses})
        ckpts = sorted(d.glob("ckpt_*.npz"))
        for old in ckpts[: -self.keep]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)

    def latest(self):
        ckpts = sorted(pathlib.Path(self.directory).glob("ckpt_*.npz"))
        return ckpts[-1].with_suffix("") if ckpts else None

    def restore(self, params_like, opt_like=None):
        latest = self.latest()
        if latest is None:
            return None
        return load_checkpoint(latest, params_like, opt_like)
