"""Plain reference of the convex problem: Eq. 1 of arXiv:1704.06731,

    f(w) = (1/n) Σ max(0, 1 − yᵢ⟨w, xᵢ⟩)² + (λ/2)‖w‖²,

its gradient, its Hessian-vector product on a prefix of the rows, and its
minimizer, in float64 over blocks of rows of the float32 inputs (which it
reads and never writes).  ``prec="tf32"`` computes the same in the
nearest precision below the configuration's float32: every product's
operands rounded to TF32 (10 bits of mantissa), float32 accumulation;
this is the control that the comparison has to refuse.

It imports nothing of the program: it is written from the equation.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 18                     # rows a block


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _cast(x, prec: str):
    if prec == "float64":
        return x.double()
    if prec == "tf32":
        return tf32(x.float())
    raise ValueError(f"unknown precision {prec!r}")


def _acc(prec: str):
    return torch.float64 if prec == "float64" else torch.float32


def value_grad(X, y, w, lam: float, *, prec: str = "float64"):
    """(f(w), ∇f(w), s) with s = |X|ᵀ|ℓ′(m)| / n + λ|w|, the magnitude of
    the gradient's summands (the scale its rounding is measured on)."""
    n, d = X.shape
    acc = _acc(prec)
    wc = _cast(w, prec)
    L = torch.zeros((), dtype=acc, device=X.device)
    g = torch.zeros((d,), dtype=acc, device=X.device)
    s = torch.zeros((d,), dtype=torch.float64, device=X.device)
    for lo in range(0, n, BLOCK):
        Xb = _cast(X[lo:lo + BLOCK], prec)
        yb = y[lo:lo + BLOCK].to(acc)
        hinge = torch.clamp(1.0 - yb * (Xb @ wc), min=0.0)
        L += torch.sum(hinge * hinge)
        r = -2.0 * hinge * yb                       # ℓ′(m)·y
        g += Xb.T @ _cast(r, prec)
        s += Xb.double().abs().T @ r.double().abs()
    w64 = w.to(acc)
    f = L / n + 0.5 * lam * torch.sum(w64 * w64)
    return f, g / n + lam * w64, s / n + lam * w.double().abs()


def hvp(X, y, w, v, lam: float, rows: int, *, prec: str = "float64"):
    """∇²f(w)·v on the first ``rows`` rows: Xᵀ diag(2·1[m < 1]) X v / rows
    + λv (the squared hinge's generalized Hessian)."""
    acc = _acc(prec)
    wc, vc = _cast(w, prec), _cast(v, prec)
    out = torch.zeros((X.shape[1],), dtype=acc, device=X.device)
    for lo in range(0, rows, BLOCK):
        hi = min(rows, lo + BLOCK)
        Xb = _cast(X[lo:hi], prec)
        m = y[lo:hi].to(acc) * (Xb @ wc)
        curv = 2.0 * (m < 1.0).to(acc)
        out += Xb.T @ _cast(curv * (Xb @ vc), prec)
    return out / rows + lam * v.to(acc)


def _hessian(X, y, w, lam: float, prec: str):
    """The whole generalized Hessian (d, d), over blocks of rows."""
    n, d = X.shape
    acc = _acc(prec)
    wc = _cast(w, prec)
    H = torch.zeros((d, d), dtype=acc, device=X.device)
    for lo in range(0, n, BLOCK):
        Xb = _cast(X[lo:lo + BLOCK], prec)
        active = (y[lo:lo + BLOCK].to(acc) * (Xb @ wc)) < 1.0
        Xa = Xb[active]
        H += 2.0 * (Xa.T @ Xa)
    H /= n
    H += lam * torch.eye(d, dtype=acc, device=X.device)
    return H


def solve(X, y, lam: float, *, prec: str = "float64", iters: int = 50):
    """The minimizer by Newton's method on the whole generalized Hessian,
    with a backtracking line search, from w = 0.  Returns (w, f(w))."""
    acc = _acc(prec)
    w = torch.zeros((X.shape[1],), dtype=acc, device=X.device)
    f, g, _ = value_grad(X, y, w, lam, prec=prec)
    for _ in range(iters):
        H = _hessian(X, y, w, lam, prec)
        step = -torch.linalg.solve(H, g)
        t = 1.0
        while t > 1e-10:
            w_new = w + t * step
            f_new, g_new, _ = value_grad(X, y, w_new, lam, prec=prec)
            if f_new <= f + 1e-4 * t * torch.dot(g, step):
                break
            t *= 0.5
        else:
            break
        done = bool(f - f_new <= 1e-15 * abs(float(f)))
        w, f, g = w_new, f_new, g_new
        if done:
            break
    return w, f
