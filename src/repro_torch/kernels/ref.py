"""Plain PyTorch versions of the port's kernels.

Each is what ``ops`` runs for tensors on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel against on the card (there in
float64).  ``flash_attention``, ``ssm_scan`` and ``rglru_scan`` are also
the functions whose autograd gives their kernels' backward passes, as the
reference's custom VJPs do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ------------------------------------------------------- fused linear grad
def linear_forward(X, w):
    return X @ w


def linear_value_grad(X, y, w, loss: str = "squared_hinge"):
    """Returns (sum loss_i, grad of sum loss_i wrt w) — the paper's convex
    hot spot: Xw -> elementwise loss' -> Xᵀr."""
    m = y * (X @ w)
    if loss == "squared_hinge":
        hinge = torch.clamp(1.0 - m, min=0.0)
        li = hinge * hinge
        dm = -2.0 * hinge
    elif loss == "logistic":
        li = F.softplus(-m)
        dm = -torch.sigmoid(-m)
    else:
        raise ValueError(loss)
    r = dm * y
    return li.sum(), X.T @ r


# -------------------------------------------------------- flash attention
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k, v: (B, H, S, hd) — plain softmax attention: scores in q's
    dtype widened to float32 (float64 stays float64), scaled by hd^-½,
    masked with -inf where k > q (causal) or q - k >= window (window > 0),
    softmax, probabilities cast back to q's dtype, then PV."""
    S, hd = q.shape[-2], q.shape[-1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(acc) / (hd ** 0.5)
    pos = torch.arange(S, device=q.device)
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (pos[None, :] <= pos[:, None])
    if window > 0:
        ok = ok & ((pos[:, None] - pos[None, :]) < window)
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)


def gqa_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """``flash_attention`` in the model's layout: q (B, S, H, hd), k, v
    (B, S, KV, hd) -> (B, S, H, hd), each KV head repeated for its H/KV
    query heads (the reference wrapper's ``jnp.repeat``)."""
    rep = q.shape[2] // k.shape[2]
    if rep != 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    out = flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                          causal=causal, window=window)
    return out.transpose(1, 2)


# --------------------------------------------------------------- ssm scan
def ssm_scan(u, delta, B_ssm, C_ssm, A_log, D):
    """Mamba selective scan, a Python loop over time that mirrors the
    reference oracle step for step.
    u, delta: (B, S, di); B_ssm, C_ssm: (B, S, N); A_log: (di, N); D: (di,).
    Returns y: (B, S, di) in u's dtype.  The carry h is float32 (float64
    when u is float64, for the card's accuracy check)."""
    acc = torch.float64 if u.dtype == torch.float64 else torch.float32
    A = -torch.exp(A_log.to(acc))                              # (di, N)
    Bsz, S, di = u.shape
    h = torch.zeros((Bsz, di, A.shape[-1]), dtype=acc, device=u.device)
    ys = []
    for t in range(S):
        d_t, u_t = delta[:, t], u[:, t]                       # (B, di)
        dA = torch.exp(d_t[..., None].to(acc) * A)             # (B, di, N)
        dBu = (d_t * u_t)[..., None].to(acc) * B_ssm[:, t, None, :].to(acc)
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, C_ssm[:, t].to(acc)))
    y = torch.stack(ys, dim=1)
    return (y + u.to(acc) * D.to(acc)).to(u.dtype)


# -------------------------------------------------------------- rg-lru scan
def rglru_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t from h_0 = 0, a Python loop over time.
    a, b: (B, S, W) -> the trajectory (B, S, W) in a's dtype; the carry is
    float32 (float64 when a is float64)."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=acc, device=a.device)
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t].to(acc) * h + b[:, t].to(acc)
        ys.append(h.to(a.dtype))
    return torch.stack(ys, dim=1)


# ------------------------------------------------------- the race's loop
def race_condition(hist, s, done, max_iters: int) -> bool:
    """Condition (3) after the race step that wrote index ``s`` of the
    histories ``hist`` (3, max_iters): ``done`` is raised when the slow
    track after ⌊(s+1)/2⌋ steps already beats the fast track after s + 1
    (``hist[0]`` slow, ``hist[1]`` fast, value after step i at index i);
    ``s`` and ``done`` are updated in place.  Returns whether another
    step runs, read on the host."""
    s1 = s + 1
    k = torch.clamp(s1 // 2 - 1, min=0)
    done.copy_((s1 >= 2) & (hist[0, k] < hist[1, s]))
    s.copy_(s1)
    return bool(~done & (s1 < max_iters))


def race_loop(step, carry: list, hist, s, done, max_iters: int):
    """The WHILE graph's loop, run eagerly: ``step(carry)``, which replaces
    the list's carries in place, and the condition, until it says stop; at
    least one step runs, as the graph's handle defaults to ``max_iters``
    > 1.  Returns the list, holding the last carry."""
    while True:
        step(carry)
        if not race_condition(hist, s, done, max_iters):
            return carry
