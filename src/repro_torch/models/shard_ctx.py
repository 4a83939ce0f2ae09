"""Activation-sharding hook — the port of ``repro.models.shard_ctx``.

The model code is mesh-agnostic; a launcher installs a sharder that maps
(tensor, kind) -> the tensor laid out as the policy wants it (the
``+act`` policies of ``launch/shardings.py`` redistribute a DTensor,
where the reference calls ``with_sharding_constraint``).  With no sharder
installed ``shard`` returns its argument itself, so a model without a
mesh runs exactly as before.

The layouts of the model under a mesh: the embedding's vocabulary
(``embed_local``) and the residual stream's (``stream``); the attention
heads' (``split_heads``, ``reshape``, ``heads_local``), the products'
(``project``), the MoE block's experts (``experts_local``), the
recurrent blocks' channels (``channels_local``: the mamba and Griffin
blocks), the loss's vocabulary (``loss_local``) and decode's cache rows
(``write_rows``); and the blocks' ends (``reduced_grad`` at a block's
input, ``residual`` at its output).  A plain tensor takes the plain
``reshape``, call or sum.  A DTensor takes a layout chosen here, not
DTensor's view strategy or its cost model, whose answers differ between
torch versions (one refuses to split a dim sharded into half heads,
another lays the projection out as a partial sum; a partial sum that
reaches a product makes either gather the weight and run the product
whole on every model shard):

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
    """``x + y``; a DTensor block output ``y`` is first laid out as the
    residual stream ``x`` (Megatron's ``g``): its partial sums (a
    row-parallel product's) reduced, its shards (a product run on the
    rows of its input, ``project``) gathered or split, so the stream
    keeps the layout it entered the model with and the next block's input
    is never a partial sum (DTensor would gather the next column-parallel
    weight and run it whole on every model shard)."""
    if _is_dtensor(x) and _is_dtensor(y):
        y = _placed(y, tuple(x.placements))
    return x + y


def stream(x, *, split: bool = True):
    """The residual stream's layout at the model's input (the embeddings):
    with ``split``, every mesh dim that holds a partial sum
    (``embed_local``'s, reduce-scattered) or a replica (split locally)
    takes a batch shard where the batch divides over it (a training
    batch), else a sequence shard where the sequence divides (prefill), so
    the layers' products gather their weights (``project``), which are
    smaller than the activations a tensor-parallel layout moves there; a
    partial sum left is reduced (replicated).  The recurrent blocks' scans
    and the decode step's cache keep their channels or sequence over
    ``model``, so their callers pass ``split=False``.  A plain tensor is
    returned as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    n = [math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                   if _shard_dim(p) == d) for d in (0, 1)]
    pl = []
    for i, p in enumerate(x.placements):
        for d in (0, 1):
            if split and (p.is_partial() or p.is_replicate()) \
                    and mesh.size(i) > 1 \
                    and x.shape[d] % (n[d] * mesh.size(i)) == 0:
                n[d] *= mesh.size(i)
                p = Shard(d)
        pl.append(Replicate() if p.is_partial() else p)
    return _placed(x, tuple(pl))


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


# ------------------------------------------------------ vocabulary layout
def embed_local(table, tokens):
    """``table[tokens]`` for the embedding table (Vp, d) and integer
    tokens (...) -> (..., d).  Plain tensors: the plain lookup.  A
    DTensor table is looked up in a vocabulary-parallel layout (the
    reference's rule puts Vp over ``model``): its d is gathered (as every
    weight under FSDP), the tokens are replicated over the vocabulary's
    mesh dims, and each vocabulary shard looks up the ids that fall in
    its rows [v0, v0 + Vp/n), zeroing the rest; the result is a partial
    sum over those dims (exactly one shard holds each row, and adding
    zeros is exact), to be reduced into the residual stream's layout
    (``stream``).  The table's gradient is a local ``index_put`` into
    each shard's own rows, a partial sum over the tokens' batch shards.
    A mesh dim that does not divide Vp holds a replica of the table."""
    if not _is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    Vp, d = table.shape
    vocab = [i for i, p in enumerate(table.placements)
             if _shard_dim(p) == 0 and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in vocab)
    if Vp % n:
        vocab, n = [], 1
    t_pl = tuple(Replicate() if i in vocab else p
                 for i, p in enumerate(tokens.placements))
    t_l = _placed(tokens, t_pl).to_local()
    w_pl = tuple(Shard(0) if i in vocab else Replicate()
                 for i in range(mesh.ndim))
    w_l = _placed(table, w_pl).to_local(grad_placements=tuple(
        Shard(0) if i in vocab else
        Partial() if _shard_dim(t_pl[i]) is not None else Replicate()
        for i in range(mesh.ndim)))
    coord = mesh.get_coordinate()
    v0 = 0
    for i in vocab:
        v0 = v0 * mesh.size(i) + coord[i]
    rows = vocab_rows(w_l, t_l, v0 * w_l.shape[0]) if vocab \
        else w_l[t_l.long()]
    out_pl = tuple(Partial() if i in vocab else p for i, p in enumerate(t_pl))
    return _from_local(rows, mesh, out_pl, tuple(tokens.shape) + (d,))


def vocab_rows(rows, tokens, v0: int):
    """One vocabulary shard's part of a lookup: ``rows`` holds the table's
    rows [v0, v0 + len(rows)); a token there gets its row, any other a
    zero row."""
    ids = tokens.long() - v0
    hit = (ids >= 0) & (ids < rows.shape[0])
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    return torch.where(hit[..., None], rows[ids.clamp(0, rows.shape[0] - 1)],
                       zero)


def loss_local(hc, lm_head, yc):
    """Σ (log Z − gold logit) over a loss chunk's tokens: hc (B, c, d),
    the LM head (d, Vp), labels yc (B, c).  Plain tensors: the plain
    lines.  DTensors: vocabulary-parallel, the reference's ``"logits"``
    rule (Vp over ``model``) kept: hc is gathered over the mesh dims that
    split the head's columns (its rows kept elsewhere), the head over the
    others, and the float32 logits (``"logits"``-pinned) stay split.
    Each vocabulary shard takes the logsumexp of its own columns and the
    gold logit of the labels that fall there (``vocab_pick``, zero
    elsewhere); only these (B, c, n_shards) parts cross the wire, never
    the logits or their gradient, and log Z is their ``logsumexp_parts``.
    Every vocabulary shard combines the same parts, so the chunk's sum is
    a replica there and a partial sum over the rows' shards; the head's
    gradient comes back column-split, hc's a partial sum over the
    vocabulary dims.  With no vocabulary dim (pure FSDP: the batch owns
    the mesh) the plain lines run on the local rows."""
    if not _is_dtensor(hc):
        logits = shard((hc @ lm_head).float(), "logits")            # (B,c,Vp)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        return torch.sum(logz - gold)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = hc.device_mesh
    B, c = hc.shape[:2]
    Vp = lm_head.shape[1]
    cols = [i for i, p in enumerate(lm_head.placements)
            if _shard_dim(p) == 1 and mesh.size(i) > 1]
    if Vp % math.prod(mesh.size(i) for i in cols):
        cols = []
    h = _placed(hc, tuple(
        p if i not in cols and _shard_dim(p) in (0, 1) else Replicate()
        for i, p in enumerate(hc.placements)))
    w = _placed(lm_head, tuple(Shard(1) if i in cols else Replicate()
                               for i in range(mesh.ndim)))
    h_l, w_l, pl = _product_local(h, w)
    logits = shard(_from_local((h_l @ w_l).float(), mesh, pl, (B, c, Vp)),
                   "logits")
    pl = tuple(logits.placements)
    vocab = [i for i, p in enumerate(pl)
             if _shard_dim(p) == 2 and mesh.size(i) > 1]
    rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(pl))
    z = logits.to_local(grad_placements=pl)
    y = _placed(yc, rows).to_local()
    if vocab:
        coord = mesh.get_coordinate()
        v0 = 0
        for i in vocab:
            v0 = v0 * mesh.size(i) + coord[i]
        n = math.prod(mesh.size(i) for i in vocab)
        part = torch.stack([torch.logsumexp(z, dim=-1),
                            vocab_pick(z, y, v0 * z.shape[-1])], dim=-1)
        # every vocabulary shard's (log Z, gold) part: (B_l, c_l, n, 2)
        parts = _placed(_from_local(
            part[:, :, None], mesh,
            tuple(Shard(2) if i in vocab else p for i, p in enumerate(pl)),
            (B, c, n, 2)), rows).to_local(grad_placements=rows)
        logz = logsumexp_parts(parts[..., 0])
        gold = parts[..., 1].sum(dim=-1)
    else:
        logz = torch.logsumexp(z, dim=-1)
        gold = torch.gather(z, -1, y[..., None].long())[..., 0]
    return _from_local(torch.sum(logz - gold), mesh, tuple(
        Replicate() if p.is_replicate() else Partial() for p in rows), ())


def vocab_pick(logits, labels, v0: int):
    """One vocabulary shard's gold logits: ``logits`` (..., V_l) holds the
    columns [v0, v0 + V_l); a label there gets its logit, any other a
    zero (exactly one shard holds each label)."""
    ids = labels.long() - v0
    hit = (ids >= 0) & (ids < logits.shape[-1])
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    picked = torch.gather(logits, -1,
                          ids.clamp(0, logits.shape[-1] - 1)[..., None])
    return torch.where(hit, picked[..., 0], zero)


def logsumexp_parts(lse):
    """log Σᵢ exp(lseᵢ) over the last dim of the shards' logsumexps, as
    m + log Σᵢ exp(lseᵢ − m) with m their detached max: a single part
    adds log(exp(0)) = 0.0 to itself, and its gradient is 1.0."""
    m = lse.detach().amax(dim=-1, keepdim=True)
    return (m + torch.log(torch.exp(lse - m).sum(dim=-1, keepdim=True))
            )[..., 0]


# ------------------------------------------------------------ cache rows
def write_rows(cache, rows, slot: int) -> None:
    """``cache[:, slot:slot + n] = rows`` in place, for a cache (B, S, ...)
    and rows (B, n, ...).  A DTensor cache is written on its local shards:
    the rows are replicated over the mesh dims that split the cache's
    sequence (the serving layout puts it over ``model``) and laid out as
    the cache elsewhere, and the shard that holds the slots writes them.
    DTensor's own slice of a split sequence is a gathered copy, so the
    write would be lost."""
    n = rows.shape[1]
    if not _is_dtensor(cache):
        cache[:, slot:slot + n].copy_(rows)
        return
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements)
           if _shard_dim(p) == 1 and mesh.size(i) > 1]
    r = _placed(rows, tuple(Replicate() if i in seq or p.is_partial() else p
                            for i, p in enumerate(cache.placements)))
    local, r = cache.to_local(), r.to_local()
    coord = mesh.get_coordinate()
    block = 0
    for i in seq:
        block = block * mesh.size(i) + coord[i]
    start = slot - block * local.shape[1]
    lo, hi = max(start, 0), min(start + n, local.shape[1])
    if lo < hi:
        local[:, lo:hi].copy_(r[:, lo - start:hi - start])


# ---------------------------------------------------------- row products
def project(x, w):
    """``x @ w`` for an activation x (..., K) and a weight w (K, N).
    Plain tensors: the plain product.  DTensors: the product of the local
    shards, each mesh dim laid out by x's placement there:

      * x split on a row dim (a batch or sequence shard): w gathered
        there (a weight is small beside the rows), the output split as x;
      * x split on K, or replicated while w's rows are split: a partial
        sum from w's row shard (x's replica split locally);
      * x replicated and w's columns split: the output's columns split;
      * else (both replicated) a replica; x's partial sums are reduced
        first.

    DTensor's own matmul flattens x's leading dims with a view, which
    some torch versions refuse where a dim after the first is sharded
    (attention's output under query blocks, split over the sequence)."""
    if not _is_dtensor(x):
        return x @ w
    x_l, w_l, y_pl = _product_local(x, w)
    return _from_local(x_l @ w_l, x.device_mesh, y_pl,
                       tuple(x.shape[:-1]) + (w.shape[1],))


def _product_local(x, w):
    """``project``'s layout: (x's local shard, w's, the product's
    placements)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    x_pl, xg_pl, w_pl, wg_pl, y_pl = [], [], [], [], []
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        k = _shard_dim(px)
        if px.is_partial():
            px, k = Replicate(), None
        if k is not None and k < last:              # rows
            row = (px, px, Replicate(), Partial(), px)
        elif k == last or _shard_dim(pw) == 0:      # the contraction
            row = (Shard(last), Shard(last), Shard(0), Shard(0), Partial())
        elif _shard_dim(pw) == 1:                   # the columns
            row = (px, Partial(), pw, pw, Shard(last))
        else:
            row = (px,) * 2 + (Replicate(),) * 3
        for acc, p in zip((x_pl, xg_pl, w_pl, wg_pl, y_pl), row):
            acc.append(p)
    x_l = _placed(x, tuple(x_pl)).to_local(grad_placements=tuple(xg_pl))
    w_l = _placed(w, tuple(w_pl)).to_local(grad_placements=tuple(wg_pl))
    return x_l, w_l, tuple(y_pl)


# --------------------------------------------------------- channel layout
def channels_local(fn: Callable, x, cols: dict, chans: dict, rows: dict,
                   state: Optional[dict] = None):
    """``fn(x, params, state, gather, reduce)`` -> (y (B, S, N), new state
    or None) for a recurrent block on x (B, S, d) whose C channels are
    independent but for the products that mix them: ``cols`` are (K, C)
    weights (the channels on their columns), ``chans`` (C, ...) per-channel
    parameters, ``rows`` (C, N) weights (the channels contracted);
    ``state`` a dict of tensors, "conv" (B, W-1, C) and the others
    (B, C, ...); ``gather`` takes (B, S', C) to all C channels and
    ``reduce`` sums a contraction over them.  Plain tensors: ``fn`` on them
    all, ``gather`` and ``reduce`` the identity.

    DTensors (the rules put the mamba block's d_inner and the Griffin
    block's LRU width over ``model``) take Megatron's layout, the same at
    every sequence length: ``fn`` gets local shards, each mesh dim holding
    a shard of the channels where ``chans``' first is split there, a batch
    shard where x's batch is, else (a decode batch of one) a block of each
    channel shard where they divide, else a replica.  x is replicated over
    the channels' dims (its gradient a partial sum there), ``cols`` are
    column-split and ``rows`` row-split there and gathered elsewhere (their
    gradients partial sums over the batch shards); ``gather`` all-gathers
    over the channels' dims (a reduce-scatter in the backward), ``reduce``
    all-reduces there (and its gradient), and y comes back a partial sum
    over them, for ``residual`` to reduce.  No step of the block is left
    to DTensor, whose layouts differ between torch versions (one gathers
    the mamba scan's state every time step) and with the sequence length
    (the Griffin block's gate products: at S = 16 the activations
    gathered, from S = 32 on the weights; mamba's ``dt_proj``), which the
    dry run's extrapolation in S cannot follow."""
    if not _is_dtensor(x):
        return fn(x, {**cols, **chans, **rows}, state, _same, _same)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    B, S = x.shape[:2]
    first = next(iter(chans.values()))
    C = first.shape[0]
    ch = [i for i, p in enumerate(first.placements)
          if _shard_dim(p) == 0 and mesh.size(i) > 1]
    n_ch = math.prod(mesh.size(i) for i in ch)
    if C % n_ch:
        ch, n_ch = [], 1
    batch = [i for i, p in enumerate(x.placements)
             if _shard_dim(p) == 0 and i not in ch and mesh.size(i) > 1]
    if B % math.prod(mesh.size(i) for i in batch):
        batch = []
    # a mesh dim with no batch shard (a decode batch of one) would run the
    # whole block on each of its shards: each takes a block of its channel
    # shard, sliced locally (a sub-block, so no weight moves)
    idle = [i for i in range(mesh.ndim)
            if i not in ch + batch and mesh.size(i) > 1]
    n_sub = math.prod(mesh.size(i) for i in idle)
    if (C // n_ch) % n_sub:
        idle, n_sub = [], 1
    c = C // n_ch // n_sub
    coord = mesh.get_coordinate()
    j = 0
    for i in idle:
        j = j * mesh.size(i) + coord[i]

    def pl(on_batch, on_ch, on_idle=Replicate()):
        return tuple(on_batch if i in batch else on_ch if i in ch else
                     on_idle if i in idle else Replicate()
                     for i in range(mesh.ndim))

    def local(t, placed, grad, dim=None):
        t = _placed(t, placed).to_local(grad_placements=grad)
        return t if dim is None or not idle else t.narrow(dim, j * c, c)

    def dim_of(k):
        return 2 if k == "conv" else 1

    def whole(t, k):
        """A state's global shape from its local shard."""
        shape = list(t.shape)
        shape[0], shape[dim_of(k)] = B, C
        return tuple(shape)

    x_l = local(x, pl(Shard(0), Replicate()),
                pl(Shard(0), Partial(), Partial()))
    params = {k: local(w, pl(Replicate(), Shard(1)),
                       pl(Partial(), Shard(1), Partial()), 1)
              for k, w in cols.items()}
    params.update({k: local(w, pl(Replicate(), Shard(0)),
                            pl(Partial(), Shard(0), Partial()), 0)
                   for k, w in {**chans, **rows}.items()})
    st = None if state is None else \
        {k: local(t, pl(Shard(0), Shard(dim_of(k))),
                  pl(Shard(0), Shard(dim_of(k)), Partial()), dim_of(k))
         for k, t in state.items()}

    def gather(t):
        # (B, S', c) -> (B, S', n_ch, n_sub, c) -> (B, S', C): the
        # channel shards in order, each its sub-blocks in order
        if not ch and not idle:
            return t
        parts = _from_local(t[:, :, None, None, :], mesh,
                            pl(Shard(0), Shard(2), Shard(3)),
                            (B, t.shape[1], n_ch, n_sub, c))
        return local(parts, pl(Shard(0), Replicate()),
                     pl(Shard(0), Partial(), Partial())).flatten(2)

    def reduce(t):
        if not ch and not idle:
            return t
        return _AllReduce.apply(t, mesh, pl(Shard(0), Partial(), Partial()),
                                pl(Shard(0), Replicate()),
                                (B,) + tuple(t.shape[1:]))

    def state_out(t, k):
        d = dim_of(k)
        if idle:
            # the sub-blocks gathered back into each channel shard
            shape = [B] + list(t.shape[1:])
            shape[d:d + 1] = [n_sub, n_ch * c]
            parts = _from_local(t.unsqueeze(d), mesh,
                                pl(Shard(0), Shard(d + 1), Shard(d)),
                                tuple(shape))
            t = _placed(parts, pl(Shard(0), Shard(d + 1))).to_local() \
                .flatten(d, d + 1)
        return _from_local(t, mesh, pl(Shard(0), Shard(d)), whole(t, k))

    y, new = fn(x_l, params, st, gather, reduce)
    y = _from_local(y, mesh, pl(Shard(0), Partial(), Partial()),
                    (B, S, y.shape[2]))
    if new is not None:
        new = {k: None if t is None else state_out(t, k)
               for k, t in new.items()}
    return y, new


def _same(t):
    return t


class _AllReduce(torch.autograd.Function):
    """A local part summed over the mesh dims where ``partial`` holds a
    partial sum, in the forward, and its gradient (each shard's part of
    it) in the backward: Megatron's g, then f, on local tensors."""

    @staticmethod
    def forward(ctx, t, mesh, partial, whole, shape):
        ctx.args = (mesh, partial, whole, shape)
        return _from_local(t, mesh, partial, shape).redistribute(
            mesh, whole).to_local()

    @staticmethod
    def backward(ctx, g):
        mesh, partial, whole, shape = ctx.args
        return (_from_local(g.contiguous(), mesh, partial, shape)
                .redistribute(mesh, whole).to_local(), None, None, None,
                None)


# ---------------------------------------------------------- expert layout
def experts_local(fn: Callable, x, router, experts: tuple, *, group: int):
    """``fn(x, router, *experts, e0)`` for x (B, S, d), the router (d, E)
    and the expert stacks (E, ...) -> (y (B, S, d), per-group terms, each
    (B·S / group, ...)).  ``fn`` routes the tokens in groups of ``group``
    and runs the experts e0 .. e0 + len(experts[0]) - 1 it is given.
    Plain tensors: ``fn(x, router, *experts, 0)``.  DTensors: ``fn`` runs
    on local shards, each mesh dim holding

      * the experts' shards, where the stacks are split by expert (the
        reference's ``_MOE_RULES``: over ``model``).  x and the router
        are replicated there: every shard routes all tokens of its batch
        shard, so the capacity drop is the one of the whole expert set,
        and builds the dispatch and combine tensors of its own experts;
        y and the gradients of x and the router come back as partial
        sums, the aux terms (the same on every shard) replicated, their
        gradient taken on the first shard only;
      * a batch shard of whole groups where the tokens of a shard divide
        into groups (x's own batch split first, then the mesh dims the
        experts do not split, if the batch divides over them); the
        stacks' gradients are partial sums there;
      * else a replica.

    No operation of the block is left to DTensor's strategies, whose
    layouts differ between torch versions (one runs the combine whole on
    every model shard, another refuses its view)."""
    if not _is_dtensor(x):
        return fn(x, router, *experts, 0)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    B, S, d = x.shape
    E = experts[0].shape[0]
    ex = [i for i, p in enumerate(experts[0].placements)
          if _shard_dim(p) == 0 and mesh.size(i) > 1]
    if E % math.prod(mesh.size(i) for i in ex):
        ex = []

    def fits(dims):
        n = math.prod(mesh.size(i) for i in dims)
        return B % n == 0 and (B // n) * S % group == 0

    batch = [i for i, p in enumerate(x.placements)
             if _shard_dim(p) == 0 and i not in ex]
    if not fits(batch):
        batch = []
    rest = [i for i in range(mesh.ndim)
            if i not in ex and i not in batch and mesh.size(i) > 1]
    if rest and fits(batch + rest):
        batch = sorted(batch + rest)

    def pl(on_batch, on_ex):
        return tuple(on_batch if i in batch else on_ex if i in ex
                     else Replicate() for i in range(mesh.ndim))

    x_l = _placed(x, pl(Shard(0), Replicate())).to_local(
        grad_placements=pl(Shard(0), Partial()))
    r_l = _placed(router, pl(Replicate(), Replicate())).to_local(
        grad_placements=pl(Partial(), Partial()))
    w_l = [_placed(w, pl(Replicate(), Shard(0))).to_local(
        grad_placements=pl(Partial(), Shard(0))) for w in experts]
    coord = mesh.get_coordinate()
    e0 = 0
    for i in ex:
        e0 = e0 * mesh.size(i) + coord[i]
    e0 *= w_l[0].shape[0]
    y, terms = fn(x_l, r_l, *w_l, e0)
    first = all(coord[i] == 0 for i in ex)
    rows = pl(Shard(0), Replicate())
    G = B * S // group
    return (_from_local(y, mesh, pl(Shard(0), Partial()), (B, S, d)),
            tuple(_from_local(t if first else _NoGrad.apply(t), mesh, rows,
                              (G,) + tuple(t.shape[1:]))
                  for t in terms))


class _NoGrad(torch.autograd.Function):
    """``x``, with no gradient flowing back (a zero one): the aux terms
    every expert shard computes alike send theirs back from one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's shard;
    the strides are worked out here, not from a tensor, which the dry
    run's counter would count."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for s in reversed(shape):
        stride.insert(0, n)
        n *= s
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
