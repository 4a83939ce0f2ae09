"""Top-k Mixture-of-Experts with GShard-style grouped einsum dispatch — the
port of ``repro.models.moe``, in plain PyTorch as the reference's is in
einsums (its ``moe`` family runs no kernel).

Tokens are reshaped into groups of at most ``moe_group_size``;
dispatch/combine tensors are (G, S_g, E, C) with capacity C = S_g·k/E ·
capacity_factor, so their footprint is linear in the token count.  A
token's slot past its expert's capacity is dropped, as in GShard/Switch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig
from .layers import swiglu


def _capacity(cfg: ModelConfig, s_g: int) -> int:
    c = int(s_g * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(cfg.experts_per_token, min(s_g, c))


def route(cfg: ModelConfig, router_w, x_g):
    """x_g: (G, S_g, d) -> (combine (G,S_g,E,C) float32, dispatch in x_g's
    dtype, aux losses {"load_balance", "router_z"})."""
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
    combine = torch.zeros((G, S_g, E, C), dtype=torch.float32,
                          device=x_g.device).index_put(
        (g_idx, s_idx, expert_ids, pos_id.clamp(max=C - 1)),
        gate_vals * kept)
    dispatch = (combine > 0).to(x_g.dtype)

    # Switch-style load-balance loss + router z-loss
    density = onehot.sum(dim=2).mean(dim=1)                     # (G,E)
    density_p = probs.mean(dim=1)                               # (G,E)
    lb_loss = E * torch.mean(torch.sum(density * density_p, dim=-1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return combine, dispatch, {"load_balance": lb_loss, "router_z": z_loss}


def moe_block(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, aux).  p: router (d,E); w_gate/up (E,d,f);
    w_down (E,f,d); with ``shared_expert``, a SwiGLU FFN beside them."""
    B, S, d = x.shape
    T = B * S
    # largest group size <= moe_group_size that divides the token count
    S_g = min(cfg.moe_group_size, T)
    while T % S_g:
        S_g -= 1
    x_g = x.reshape(T // S_g, S_g, d)
    combine, dispatch, aux = route(cfg, p["router"], x_g)

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x_g)   # (E,G,C,d)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, p["w_gate"]))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, p["w_up"])
    expert_out = torch.einsum("egcf,efd->egcd", h, p["w_down"])  # (E,G,C,d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out)
    y = y.reshape(B, S, d)
    if cfg.shared_expert and cfg.d_ff:
        y = y + swiglu(x, p["shared_w_gate"], p["shared_w_up"],
                       p["shared_w_down"])
    return y, aux
