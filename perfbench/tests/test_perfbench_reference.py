"""The plain reference at tiny sizes on the CPU, against autograd of Eq. 1
in float64."""
from __future__ import annotations

import pytest
import torch

from perfbench.reference import convex
from perfbench.yardstick import data

CFG = {"name": "tiny", "n": 3000, "d": 12, "condition": 30.0,
       "noise": 0.2, "lam": 1e-3}


def _f(X, y, w, lam):
    m = y * (X @ w)
    return torch.mean(torch.clamp(1 - m, min=0) ** 2) + 0.5 * lam * w @ w


def test_perfbench_convex_reference_against_autograd():
    X, y = data.classification(CFG, 5, "cpu")
    w = 0.3 * torch.randn(12, generator=torch.Generator().manual_seed(1))
    v = torch.randn(12, generator=torch.Generator().manual_seed(2))
    f, g, s = convex.value_grad(X, y, w, CFG["lam"])
    w64 = w.double().requires_grad_(True)
    f_ad = _f(X.double(), y.double(), w64, CFG["lam"])
    (g_ad,) = torch.autograd.grad(f_ad, w64, create_graph=True)
    assert float(f) == pytest.approx(float(f_ad.detach()), rel=1e-12)
    torch.testing.assert_close(g, g_ad.detach(), rtol=1e-10, atol=1e-12)
    assert bool((s >= g.abs()).all())
    k = 1000
    w2 = w.double().requires_grad_(True)
    (gk,) = torch.autograd.grad(_f(X[:k].double(), y[:k].double(), w2,
                                   CFG["lam"]), w2, create_graph=True)
    (hv,) = torch.autograd.grad(gk @ v.double(), w2)
    torch.testing.assert_close(convex.hvp(X, y, w, v, CFG["lam"], k), hv,
                               rtol=1e-10, atol=1e-12)


def test_perfbench_convex_reference_solves_and_tf32_rounds():
    X, y = data.classification(CFG, 6, "cpu")
    w, f = convex.solve(X, y, CFG["lam"])
    _, g, s = convex.value_grad(X, y, w, CFG["lam"])
    assert float(g.norm() / s.norm()) < 1e-10
    t = convex.tf32(torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                                  3.0]))
    assert t.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
    w32, f32 = convex.solve(X, y, CFG["lam"], prec="tf32")
    assert abs(float(f32) - float(f)) < 1e-3 * float(f)
