"""Closed forms from §3.3, §4 and Theorem 4.1, used by tests and the
Table-1 benchmark to check the implementation against the paper's algebra.
Pure Python: a copy of ``repro.core.theory``."""
from __future__ import annotations

import math


def kappa_hat(kappa: float) -> int:
    """κ̂ = ⌈κ log 6⌉ (Algorithm 3)."""
    return math.ceil(kappa * math.log(6.0))


def num_stages(eps0: float, eps: float) -> int:
    """T = O(log(ε₀/ε)); exact: smallest T with ε₀/2^T ≤ ε/3 ⇒ loop guard
    3·ε_t > ε of Algorithm 3."""
    T = 0
    e = eps0
    while 3.0 * e > eps:
        e /= 2.0
        T += 1
    return T


def bet_data_accesses(n0: int, kappa_h: int, T: int, passes_per_update: float = 1.0) -> float:
    """Σ_{t=1..T} κ̂·C·n_t with n_t = n0·2^t  (proof of Thm 4.1)."""
    return passes_per_update * kappa_h * n0 * sum(2 ** t for t in range(1, T + 1))


def batch_data_accesses(N: int, kappa_h: int, T: int, passes_per_update: float = 1.0) -> float:
    """Same optimizer, full batch from the start: κ̂·C·N per stage-equivalent."""
    return passes_per_update * kappa_h * N * T


def table1_time(method: str, *, a: float, p: float, s: float, kappa: float,
                eps: float, n_bet: float, b: int = 64,
                kappa_d: float = 1.0, kappa_m: float = 1.0) -> float:
    """Normalized time complexities of Table 1, times N_BET(ε) = n_bet."""
    if method == "batch":
        return n_bet * (a + kappa * math.log(1.0 / eps) / p)
    if method == "bet":
        return n_bet * (a + kappa / p)
    if method == "dsm":
        return n_bet * (a + 1.0 / p) * kappa_d
    if method == "minibatch":
        # (a + 1/p)·κ_m + sequentiality s/b per access
        return n_bet * ((a + 1.0 / p) * kappa_m + s / b * kappa_m)
    raise ValueError(method)


def tolerance_schedule(eps0: float, T: int) -> list:
    return [eps0 / (2 ** t) for t in range(T + 1)]


def estimation_error_bound(L: float, B: float, lam: float, n: int,
                           delta: float = 0.1, T: int = 10) -> float:
    """O(L²B²·log(T/δ)/(λ n)) — Lemma 2's uniform bound, up to the hidden
    numeric constant (returned with constant 1)."""
    return (L * L * B * B * math.log(T / delta)) / (lam * n)
