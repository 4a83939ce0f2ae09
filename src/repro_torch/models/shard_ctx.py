"""Activation-sharding hook — the port of ``repro.models.shard_ctx``.

The model code is mesh-agnostic; a launcher installs a sharder that maps
(tensor, kind) -> the tensor laid out as the policy wants it (the
``+act`` policies of ``launch/shardings.py`` redistribute a DTensor,
where the reference calls ``with_sharding_constraint``).  With no sharder
installed ``shard`` returns its argument itself, so a model without a
mesh runs exactly as before.

The layouts of a layer's tensor-parallel blocks: the attention heads'
(``split_heads``, ``reshape``, ``heads_local``) and the blocks' ends
(``reduced_grad`` at a block's input, ``residual`` at its output).  A
plain tensor takes the plain ``reshape``, call or sum.  A DTensor takes a
layout chosen here, not DTensor's view strategy or its cost model, whose
answers differ between torch versions (one refuses to split a dim sharded
into half heads, another lays the projection out as a partial sum; a
partial sum that reaches a product makes either gather the weight and run
the product whole on every model shard):

  * a split of the projection into heads shards the head dim wherever the
    projection's last dim is sharded or a partial sum, if the heads divide
    over those mesh dims; else the batch, if it divides; else it
    replicates it there (qwen3-0.6b's train step on a 16-way ``model``
    axis: q's 16 heads one a shard, k's and v's 8 heads a batch shard);
  * every reshape is a reshape of each local shard, with the placements
    carried to the new dims; a mesh dim whose shard would not stay a
    block of the new dims is replicated first;
  * the attention between split and merge runs on the local shards
    (``heads_local``): batch shards and whole heads are independent, a
    shard of q's heads reads the k/v heads of its groups from replicated
    k and v, and their gradients come back as partial sums.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

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


# ------------------------------------------------------------ head layout
def _is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def reduced_grad(x):
    """``x``; in the backward pass a DTensor's gradient that comes back as
    a partial sum over a mesh dim is all-reduced there (Megatron's ``f``
    at a tensor-parallel block's input).  A layer's normed input feeds the
    column-parallel products, whose input gradients are partial sums over
    ``model``: reduced here, the residual stream's gradient stays
    replicated, and no row-parallel product's backward meets a partial
    sum (DTensor would gather its weight and run it whole on every model
    shard)."""
    if not _is_dtensor(x):
        return x
    return _ReducedGrad.apply(x)


class _ReducedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _is_dtensor(g) and any(p.is_partial() for p in g.placements):
            from torch.distributed.tensor import Replicate
            g = g.redistribute(g.device_mesh, tuple(
                Replicate() if p.is_partial() else p for p in g.placements))
        return g


def residual(x, y):
    """``x + y``; a DTensor block output ``y``'s partial sums (a
    row-parallel product's) are first reduced into the residual stream
    ``x``'s layout (Megatron's ``g``), so the next block's input is never a
    partial sum (DTensor would gather the next column-parallel weight and
    run it whole on every model shard)."""
    if _is_dtensor(x) and _is_dtensor(y) \
            and any(p.is_partial() for p in y.placements):
        y = _placed(y, tuple(px if py.is_partial() else py
                             for px, py in zip(x.placements, y.placements)))
    return x + y


def split_heads(x, heads: int, head_dim: int):
    """(B, S, heads·head_dim) -> (B, S, heads, head_dim)."""
    B, S = x.shape[:2]
    if not _is_dtensor(x):
        return x.reshape(B, S, heads, head_dim)
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    model = [i for i, p in enumerate(x.placements)
             if p.is_partial() or _shard_dim(p) == last]
    n = math.prod(x.device_mesh.size(i) for i in model)
    nb = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                   if _shard_dim(p) == 0)
    head = Shard(last) if heads % n == 0 else \
        Shard(0) if B % (nb * n) == 0 else Replicate()
    pl = tuple(head if i in model else p for i, p in enumerate(x.placements))
    return reshape(_placed(x, pl), (B, S, heads, head_dim))


def reshape(x, shape):
    """``x.reshape(shape)``; a DTensor's is a reshape of each local shard
    (the module docstring), a partial sum staying one (a reshape is
    linear; only the decode step, which records no gradient, reshapes
    one)."""
    if not _is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    shape = tuple(int(s) for s in shape)
    src = tuple(x.shape)
    groups = _groups(src, shape)

    def n_of(d):
        return math.prod(x.device_mesh.size(i)
                         for i, p in enumerate(x.placements)
                         if _shard_dim(p) == d)

    def target(p):
        d = _shard_dim(p)
        if d is None:
            return p if p.is_replicate() or p.is_partial() else None
        ins, outs = next(g for g in groups if d in g[0])
        if len(ins) == 1 and len(outs) == 1:
            return Shard(outs[0])
        n = n_of(d)
        whole = all(n_of(e) == 1 for e in ins if e != d)
        if outs and d == ins[0] and whole and src[d] % n == 0 \
                and shape[outs[0]] % n == 0:
            return Shard(outs[0])
        return None

    # a tensor dim is replicated on all its mesh dims where one of them
    # cannot carry its shard over
    bad = {_shard_dim(p) for p in x.placements if target(p) is None}
    if bad:
        x = _placed(x, tuple(
            Replicate() if target(p) is None
            or (_shard_dim(p) is not None and _shard_dim(p) in bad) else p
            for p in x.placements))
    local = x.to_local()
    lshape = list(shape)
    for ins, outs in groups:
        if len(ins) == 1 and len(outs) == 1:
            lshape[outs[0]] = local.shape[ins[0]]
        elif outs:
            lshape[outs[0]] = shape[outs[0]] // n_of(ins[0])
    return _from_local(local.reshape(lshape), x.device_mesh,
                       tuple(target(p) for p in x.placements), shape)


def heads_local(fn: Callable, q, k, v, *, query_blocks: bool = False):
    """``fn(q, k, v)`` for q (B,S,H,hd), k and v (B,S,KV,hd'), whose output
    is laid out as q.  DTensors: ``fn`` runs on local shards (the module
    docstring), each mesh dim holding a batch shard, a shard of whole
    heads, or, where the heads do not divide: a batch shard if the batch
    divides, else with ``query_blocks`` (``fn`` then takes ``q_offset``,
    the position of its first query among the keys) a block of the
    queries against all the keys; else a replica."""
    if not _is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    B, S, H = q.shape[:3]
    KV = k.shape[2]
    G = H // KV
    heads = [i for i, p in enumerate(q.placements) if _shard_dim(p) == 2]
    n = math.prod(mesh.size(i) for i in heads)
    Hl = H // n
    if H % n or not (Hl % G == 0 or G % Hl == 0):
        heads, n, Hl = [], 1, H         # no grouping fits: all heads local
    # the other mesh dims split the batch further, or the queries
    rest = [i for i, p in enumerate(q.placements)
            if _shard_dim(p) != 0 and i not in heads and mesh.size(i) > 1]
    m = math.prod(mesh.size(i) for i in rest)
    nb = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                   if _shard_dim(p) == 0)
    batch = rest if B % (nb * m) == 0 else []
    rows = rest if not batch and query_blocks and S % m == 0 else []
    m = math.prod(mesh.size(i) for i in rows)
    kv_head = Shard(2) if KV % n == 0 else Replicate()
    q_pl = tuple(Shard(0) if _shard_dim(p) == 0 or i in batch else
                 Shard(2) if i in heads else
                 Shard(1) if i in rows else Replicate()
                 for i, p in enumerate(q.placements))
    kv_pl = tuple(kv_head if i in heads else
                  Replicate() if i in rows else p
                  for i, p in enumerate(q_pl))
    # k and v replicated over q's head shards or query blocks: each
    # shard's gradient is its part of the sum
    grad_pl = tuple(Partial() if (i in heads and KV % n) or i in rows
                    else p for i, p in enumerate(kv_pl))
    local = [_placed(q, q_pl).to_local()] + [
        _placed(t, kv_pl).to_local(grad_placements=grad_pl) for t in (k, v)]
    coord = mesh.get_coordinate()

    def block(dims):
        idx = 0
        for i in dims:
            idx = idx * mesh.size(i) + coord[i]
        return idx

    if heads and KV % n:
        # this shard's q heads h0 .. h0+Hl-1 read k/v heads h // G
        kv0, kvn = block(heads) * Hl // G, max(Hl // G, 1)
        local[1:] = [t[:, :, kv0:kv0 + kvn] for t in local[1:]]
    out = fn(*local, q_offset=block(rows) * (S // m)) if rows \
        else fn(*local)
    return _from_local(out, mesh, q_pl, (B, S, H, out.shape[3]))


def _from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's shard;
    the strides are worked out here, not from a tensor, which the dry
    run's counter would count."""
    from torch.distributed.tensor import DTensor
    stride = [1]
    for s in reversed(shape[1:]):
        stride.insert(0, stride[0] * s)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _shard_dim(p):
    """The tensor dim of a plain ``Shard`` placement, else None."""
    from torch.distributed.tensor import Shard
    return p.dim if type(p) is Shard else None


def _placed(x, placements: tuple):
    return x if tuple(x.placements) == placements else \
        x.redistribute(x.device_mesh, placements)


def _groups(src: tuple, dst: tuple) -> list:
    """A reshape as groups (source dims, destination dims) of equal
    products, in order: (B, S, 16, 128) -> (B, S, 2048) is ([0], [0]),
    ([1], [1]), ([2, 3], [2])."""
    if math.prod(src) != math.prod(dst):
        raise ValueError(f"cannot reshape {src} to {dst}")
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        ins, outs, a, b = [], [], 1, 1
        if i < len(src):
            ins.append(i)
            a = src[i]
            i += 1
        if j < len(dst):
            outs.append(j)
            b = dst[j]
            j += 1
        while a != b:
            if a < b:
                ins.append(i)
                a *= src[i]
                i += 1
            else:
                outs.append(j)
                b *= dst[j]
                j += 1
        groups.append((ins, outs))
    return groups
