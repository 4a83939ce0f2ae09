"""Public wrappers around the port's kernels: dispatch by device.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``ref.py``), as does a meta tensor within ``plain_on_meta`` (where a
caller counts a step's operations on meta tensors); a tensor on a CUDA
device goes to the hand-written kernel, or the call raises — there is
no fallback from the card to the plain version.

``flash_attention``, ``ssm_scan`` and ``rglru_scan`` are differentiable,
as the reference's are: the kernel is the forward pass and the backward
pass is the VJP of the plain version, recomputed from the saved inputs
(``torch.autograd.Function``; the reference wraps its Pallas kernels in a
``custom_vjp`` the same way and has no backward kernels either).

``CALLS`` counts kernel launches per kernel (reset with ``reset_calls``):
a run on the card proves with it that its main path went through the
kernels.  Calls served by the plain version on the CPU are not counted,
nor is the backward pass, which launches no kernel of this package.

``ROUTED`` counts every call of a kernel's wrapper on either route, the
card's or the plain version's on the CPU: what the reference's ``CALLS``
counts (its trace-time dispatches), and what the workload sweep's
``kernel_routed`` claim reads on the CPU, where nothing launches.

``race_loop`` runs the Two-Track race's loop: the WHILE graph of
``device_while.py`` on the card, the plain loop on the CPU.  A captured
race step counts its launches once, while it is captured; the card runs
it once for every step after the first, so ``finish_race_loop`` adds the
body's launches for each step that Python did not count (all of them
when ``rerun_race_loop`` launched the graph again), once the caller has
pulled the step count.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars

import torch

from . import device_while as _dw
from . import flash_attention as _fa
from . import linear_grad as _lg
from . import ref as _ref
from . import rglru_scan as _rg
from . import ssm_scan as _ss

CALLS: collections.Counter = collections.Counter()
ROUTED: collections.Counter = collections.Counter()


def reset_calls() -> None:
    CALLS.clear()
    ROUTED.clear()


_PLAIN_ON_META = contextvars.ContextVar("plain_on_meta", default=False)


@contextlib.contextmanager
def plain_on_meta():
    """Within it, in this thread or task, a meta tensor goes to the plain
    version too, which then computes nothing; outside, a wrapper refuses
    it."""
    token = _PLAIN_ON_META.set(True)
    try:
        yield
    finally:
        _PLAIN_ON_META.reset(token)


def _on_card(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (and for a meta one
    within ``plain_on_meta``, which ``ROUTED`` does not count); raises
    otherwise."""
    kind = t.device.type
    if kind == "meta" and _PLAIN_ON_META.get():
        return False
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on 'cuda' or 'cpu', got {t.device}")
    ROUTED[name] += 1
    return kind == "cuda"


def linear_forward(X, w):
    # forward margins alone are a plain GEMV; the fused win is in value_grad
    return X @ w


def linear_value_grad(X, y, w, *, loss: str = "squared_hinge"):
    """(Σ loss_i, Xᵀ(ℓ′⊙y)) for X (n, d), y (n,), w (d,) — the kernel on
    the card, the plain version on the CPU."""
    if not _on_card("linear_value_grad", X):
        return _ref.linear_value_grad(X, y, w, loss=loss)
    out = _lg.linear_value_grad(X, y, w, loss=loss)
    CALLS["linear_value_grad"] += 1
    return out


def _plain_vjp(plain, saved, need, g, **kw):
    """The gradients of ``plain(*saved, **kw)`` against cotangent ``g``
    for the inputs ``need`` marks (None for the others), recomputed from
    the saved inputs."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
    with torch.enable_grad():
        y = plain(*inputs, **kw)
    wanted = [t for t, n in zip(inputs, need) if n]
    grads = iter(torch.autograd.grad(y, wanted, g))
    return tuple(next(grads) if n else None for n in need)


# -------------------------------------------------------- flash attention
class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window)
        if not _on_card("flash_attention", q):
            return _ref.gqa_attention(q, k, v, causal=causal, window=window)
        out = _fa.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)
        CALLS["flash_attention"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(_ref.gqa_attention, ctx.saved_tensors,
                          ctx.needs_input_grad[:3], g,
                          **ctx.mask) + (None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention in the model's layout, q (B, S, H, hd) and k, v
    (B, S, KV, hd) -> (B, S, H, hd), GQA by head groups, any S — the
    kernel on the card, the plain version on the CPU; differentiable in
    q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window)


# --------------------------------------------------------------- ssm scan
class _SSMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, B_ssm, C_ssm, A_log, D):
        ctx.save_for_backward(u, delta, B_ssm, C_ssm, A_log, D)
        if not _on_card("ssm_scan", u):
            return _ref.ssm_scan(u, delta, B_ssm, C_ssm, A_log, D)
        y = _ss.ssm_scan(*(t.contiguous()
                           for t in (u, delta, B_ssm, C_ssm, A_log, D)))
        CALLS["ssm_scan"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(_ref.ssm_scan, ctx.saved_tensors,
                          ctx.needs_input_grad, g)


def ssm_scan(u, delta, B_ssm, C_ssm, A_log, D):
    """Mamba selective scan y (B, S, di) for u, delta (B, S, di), B_ssm,
    C_ssm (B, S, N), A_log (di, N), D (di,) — the kernel on the card, the
    plain version on the CPU; differentiable in all six."""
    return _SSMScan.apply(u, delta, B_ssm, C_ssm, A_log, D)


# ------------------------------------------------------------- rglru scan
class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if not _on_card("rglru_scan", a):
            return _ref.rglru_scan(a, b)
        y = _rg.rglru_scan(a.contiguous(), b.contiguous())
        CALLS["rglru_scan"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(_ref.rglru_scan, ctx.saved_tensors,
                          ctx.needs_input_grad, g)


def rglru_scan(a, b):
    """The trajectory of h_t = a_t·h_{t-1} + b_t from h_0 = 0, a, b
    (B, S, W) -> (B, S, W) in a's dtype — the kernel on the card, the plain
    version on the CPU; differentiable in a and b."""
    return _RGLRUScan.apply(a, b)


# ------------------------------------------------------------- race loop
class _PlainLoop:
    """The plain loop's result, shaped as a ``device_while.WhileLoop``."""
    capture_s = 0.0
    replayable = False
    counted = 0
    body: collections.Counter = collections.Counter()

    def __init__(self, carry):
        self.carry = carry

    def close(self) -> None:
        pass


def race_loop(step, carry, hist, s, done, max_iters: int, keep=()):
    """Repeat ``carry = step(carry)`` and condition (3) on the histories
    ``hist`` (3, max_iters) at the device step index ``s`` until the
    trigger (``done``) or ``max_iters`` steps: one launch of the WHILE
    graph on the card (nothing read back), the plain loop on the CPU.  The
    returned loop's ``carry`` holds the last step's carry once the launch
    has run; pass the loop to ``finish_race_loop`` after reading ``s``.
    The graph writes its carry in place, never into the memory of a
    tensor of ``keep``."""
    if not _on_card("device_while", hist):
        return _PlainLoop(_ref.race_loop(step, carry, hist, s, done,
                                         max_iters))
    before = collections.Counter(CALLS)
    loop = _dw.WhileLoop(step, carry, hist, s, done, max_iters, keep)
    loop.body = CALLS - before
    loop.counted = 2            # step 1 ran eagerly, step 2 was captured
    CALLS["device_while"] += 1
    return loop


def rerun_race_loop(loop, carry) -> None:
    """Launch a captured loop again from ``carry`` (its ``s`` and flag
    reset by the caller), from step 1: every step is a replay."""
    loop.relaunch(carry)
    loop.counted = 0
    CALLS["device_while"] += 1


def finish_race_loop(loop, steps: int, close: bool = True) -> None:
    """Count the captured body's launches for the replays of the
    ``steps`` the loop's launch ended at that Python did not count, and
    free the loop unless ``close`` is false (it is launched again)."""
    for name, n in loop.body.items():
        CALLS[name] += n * (steps - loop.counted)
    if close:
        loop.close()
