"""Activation-sharding hook — the port of ``repro.models.shard_ctx``.

The model code is mesh-agnostic; a launcher installs a sharder that maps
(tensor, kind) -> the tensor laid out as the policy wants it (the
``+act`` policies of ``launch/shardings.py`` redistribute a DTensor,
where the reference calls ``with_sharding_constraint``).  With no sharder
installed ``shard`` returns its argument itself, so a model without a
mesh runs exactly as before.
"""
from __future__ import annotations

from typing import Callable, Optional

_SHARDER: Optional[Callable] = None


def set_sharder(fn: Optional[Callable]) -> None:
    global _SHARDER
    _SHARDER = fn


def shard(x, kind: str):
    """kinds: act_btd (B,S,d) | logits (B,C,V) | attn_batch (B,S,H,hd) |
    act_btd_full (B,S,q_dim)."""
    if _SHARDER is None:
        return x
    return _SHARDER(x, kind)
