"""Top-k Mixture-of-Experts with GShard-style grouped einsum dispatch — the
port of ``repro.models.moe``, in plain PyTorch as the reference's is in
einsums (its ``moe`` family runs no kernel).

Tokens are reshaped into groups of at most ``moe_group_size``;
dispatch/combine tensors are (G, S_g, E, C) with capacity C = S_g·k/E ·
capacity_factor, so their footprint is linear in the token count.  A
token's slot past its expert's capacity is dropped, as in GShard/Switch.
Under a mesh the block runs on local shards, experts over ``model``
(``shard_ctx.experts_local``); a model shard builds the dispatch and
combine tensors of its own experts only.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .common import ModelConfig
from .layers import swiglu
from .shard_ctx import experts_local


def _capacity(cfg: ModelConfig, s_g: int) -> int:
    c = int(s_g * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(cfg.experts_per_token, min(s_g, c))


def route(cfg: ModelConfig, router_w, x_g):
    """x_g: (G, S_g, d) -> (combine (G,S_g,E,C) float32, dispatch in x_g's
    dtype, aux losses {"load_balance", "router_z"})."""
    combine, dispatch, terms = _route(cfg, router_w, x_g)
    return combine, dispatch, _aux(cfg, *terms)


def _route(cfg: ModelConfig, router_w, x_g, e0: int = 0,
           experts: int | None = None):
    """``route`` with the combine and dispatch tensors of experts e0 ..
    e0 + experts - 1 only (all of them by default), and the aux losses'
    per-group terms before their means (``_aux``)."""
    G, S_g, _ = x_g.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, S_g)
    logits = x_g.float() @ router_w.float()                     # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    # top-k by a stable descending sort: equal probabilities keep the
    # lower expert first, as jax.lax.top_k does (the capacity drop
    # depends on the slot order)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :K], expert_ids[..., :K]
    # renormalize top-k gates (standard for k>1)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(expert_ids, E).float()                   # (G,S,K,E)
    # position of each (token, slot) within its expert queue, counted over
    # the flattened (S, K) order
    flat = onehot.reshape(G, S_g * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, S_g, K, E)
    pos_id = (pos * onehot).sum(dim=-1).long()                  # (G,S,K)
    kept = ((pos < C).float() * onehot).sum(dim=-1)             # (G,S,K)
    # combine[g, s, e, c] = gate·kept of the one slot k of token s routed
    # to expert e at queue position c: the reference's three-way einsum
    # as a scatter, with the same float32 values.  Top-k experts are
    # distinct, so each (g, s, e) takes one write; a dropped slot writes
    # its 0 at the last position of its own (g, s, e)
    g_idx = torch.arange(G, device=x_g.device)[:, None, None].expand_as(
        expert_ids)
    s_idx = torch.arange(S_g, device=x_g.device)[None, :, None].expand_as(
        expert_ids)
    El = experts or E
    if El == E:
        combine = torch.zeros((G, S_g, E, C), dtype=torch.float32,
                              device=x_g.device).index_put(
            (g_idx, s_idx, expert_ids, pos_id.clamp(max=C - 1)),
            gate_vals * kept)
    else:
        # a slot routed to another shard's expert writes into a column
        # past the local ones, dropped after
        local = expert_ids - e0
        local = torch.where((local >= 0) & (local < El), local, El)
        combine = torch.zeros((G, S_g, El + 1, C), dtype=torch.float32,
                              device=x_g.device).index_put(
            (g_idx, s_idx, local, pos_id.clamp(max=C - 1)),
            gate_vals * kept)[:, :, :El]
    dispatch = (combine > 0).to(x_g.dtype)

    # Switch-style load-balance loss + router z-loss, per group
    density = onehot.sum(dim=2).mean(dim=1)                     # (G,E)
    density_p = probs.mean(dim=1)                               # (G,E)
    terms = (torch.sum(density * density_p, dim=-1),            # (G,)
             torch.logsumexp(logits, dim=-1) ** 2)              # (G,S)
    return combine, dispatch, terms


def _aux(cfg: ModelConfig, balance, z):
    """The aux losses from ``_route``'s per-group terms."""
    return {"load_balance": cfg.num_experts * torch.mean(balance),
            "router_z": torch.mean(z)}


def _experts(cfg: ModelConfig, S_g: int, x, router, w_gate, w_up, w_down,
             e0: int = 0):
    """x: (B, S, d) in groups of S_g tokens through the experts e0 ..
    e0 + len(w_gate) - 1 -> (their part of the output, ``_route``'s aux
    terms)."""
    B, S, d = x.shape
    x_g = x.reshape(B * S // S_g, S_g, d)
    combine, dispatch, terms = _route(cfg, router, x_g, e0, w_gate.shape[0])

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x_g)   # (E,G,C,d)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, w_gate))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, w_up)
    expert_out = torch.einsum("egcf,efd->egcd", h, w_down)      # (E,G,C,d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out)
    return y.reshape(B, S, d), terms


def moe_block(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, aux).  p: router (d,E); w_gate/up (E,d,f);
    w_down (E,f,d); with ``shared_expert``, a SwiGLU FFN beside them.
    Under a mesh the experts run in ``shard_ctx.experts_local``'s
    layout."""
    B, S, d = x.shape
    T = B * S
    # largest group size <= moe_group_size that divides the token count
    S_g = min(cfg.moe_group_size, T)
    while T % S_g:
        S_g -= 1
    y, terms = experts_local(functools.partial(_experts, cfg, S_g), x,
                             p["router"], (p["w_gate"], p["w_up"],
                                           p["w_down"]), group=S_g)
    aux = _aux(cfg, *terms)
    if cfg.shared_expert and cfg.d_ff:
        y = y + swiglu(x, p["shared_w_gate"], p["shared_w_up"],
                       p["shared_w_down"])
    return y, aux
