"""Carry parameters and optimizer state across from the JAX reference.

The reference's pytrees (parameters such as ``w``, optimizer states such
as ``{"t": ...}`` or ``{"alpha_prev": ...}``), exported on the reference's
side as numpy arrays (``jax.device_get`` gives exactly that), become the
port's tensors on ``device`` with their dtypes kept.  Written over nested
dicts, lists and tuples, so model parameter trees of later slices go
through the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_from_jax(tree, device="cuda"):
    """numpy leaves -> tensors on ``device``; dicts, lists and tuples keep
    their structure; Python scalars and None pass through."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(x, copy=True)).to(dev)
        if x is None or isinstance(x, (bool, int, float)):
            return x
        raise TypeError(f"params_from_jax takes numpy arrays in nested "
                        f"dicts/lists/tuples, got {type(x).__name__}")
    return conv(tree)
