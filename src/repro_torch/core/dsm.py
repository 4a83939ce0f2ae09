"""Dynamic Sample-size Method (Byrd, Chin, Nocedal, Wu; Math. Prog. 2012) —
the port of ``repro.core.dsm``, the paper's closest competitor (§2, §5,
App. A.2), and the mini-batch baseline.

Each DSM iteration draws a *fresh i.i.d. sample* S of size n (resampling —
the resource cost BET avoids), performs one inner-optimizer update on it,
and tests the gradient-variance condition

    ‖Var_{i∈S}[∇ℓ_i(w)]‖₁ / |S| ≤ θ² ‖∇f_S(w)‖²  .

If the test fails the sample size is increased geometrically.  θ is the
sensitivity parameter the paper's App. A.2 sweeps (Fig. 8).  Because
samples are resampled, cross-update optimizer memory is invalid: it is
reset every step.

Samples are drawn on the host by ``np.random.default_rng(seed)`` in the
reference's order, so both packages see the same rows; each draw's row
indices go to the device in one copy and the rows are gathered there.
DSM reads its test's outcome back once per iteration (the next sample's
size depends on it); the mini-batch baseline steps through a record
interval's pre-drawn batches with no host read and pulls once per
recorded point.  ``trace.meta["host_transfers"]`` counts the pulls.  The
same trigger applied to BET's *expanding window* (no resampling) is
``engine.GradientVariance``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..optim.api import BatchOptimizer, Objective
from .engine import variance_stats
from .timemodel import SimulatedClock
from .trace import Trace


def _rows(dataset, idx: np.ndarray):
    """The rows ``idx`` (any shape) of (X, y), gathered on the device."""
    i = torch.from_numpy(idx).to(dataset.X.device)
    return dataset.X[i], dataset.y[i]


def _start(dataset, w0):
    return w0 if w0 is not None else torch.zeros(
        (dataset.d,), dtype=torch.float32, device=dataset.X.device)


def run_dsm(dataset, optimizer: BatchOptimizer, objective: Objective, *,
            theta: float = 0.5, n0: int = 200, growth: float = 2.0,
            steps: int = 200, clock: SimulatedClock | None = None,
            w0=None, seed: int = 0) -> Trace:
    clock = clock or SimulatedClock()
    full_data = (dataset.X, dataset.y)
    N = dataset.n
    rng = np.random.default_rng(seed)
    w = _start(dataset, w0)
    n = n0
    trace = Trace("dsm", meta={"optimizer": optimizer.name, "theta": theta})
    for k in range(steps):
        idx = rng.choice(N, size=min(n, N), replace=False)
        sample = _rows(dataset, idx)
        state = optimizer.reset_memory(optimizer.init(w))  # no cross-sample memory
        w, state, aux = optimizer.step(w, state, objective, sample)
        # variance test on a bounded probe (cost charged as compute)
        probe = min(len(idx), 512)
        v, g2 = variance_stats(objective, w, sample, probe)
        host = torch.stack([aux["f"], v, g2, objective(w, full_data)]) \
            .double().cpu().numpy()
        f_win, v, g2, f_full = (float(x) for x in host)
        clock.stochastic_update(len(idx))                  # resampled accesses
        clock.eval_pass(probe)
        if v > (theta ** 2) * max(g2, 1e-30) and n < N:
            n = min(N, int(np.ceil(n * growth)))
        trace.add(step=k, stage=0, window=n, time=clock.time,
                  accesses=clock.data_accesses, f_window=f_win,
                  f_full=f_full, extra={"var": v, "g2": g2})
    trace.params = w
    trace.meta["host_transfers"] = steps
    return trace


def run_minibatch(dataset, optimizer: BatchOptimizer, objective: Objective, *,
                  batch_size: int = 64, steps: int = 2000,
                  clock: SimulatedClock | None = None, w0=None,
                  seed: int = 0, record_every: int = 20) -> Trace:
    """Mini-batch stochastic baseline (Adagrad in the paper's §5).

    Each record interval's batches are drawn on the host up front, gathered
    on the device with one copy of their indices, and stepped through with
    no host read; one pull per recorded point brings its values back."""
    clock = clock or SimulatedClock()
    full_data = (dataset.X, dataset.y)
    N = dataset.n
    rng = np.random.default_rng(seed)
    w = _start(dataset, w0)
    state = optimizer.init(w)
    trace = Trace("minibatch", meta={"optimizer": optimizer.name,
                                     "batch_size": batch_size})
    trace.meta["host_transfers"] = 0
    if steps <= 0:
        trace.params = w
        return trace
    # record points as the reference's: every record_every-th step plus
    # the last; the gaps between them run with no host read
    record_at = sorted({k for k in range(steps) if k % record_every == 0}
                       | {steps - 1})
    start = 0
    for k_rec in record_at:
        block = range(start, k_rec + 1)
        idx = np.stack([rng.choice(N, size=batch_size, replace=False)
                        for _ in block])
        Xc, yc = _rows(dataset, idx)                       # (len(block), b, ·)
        for j in range(len(block)):
            w, state, aux = optimizer.step(w, state, objective,
                                           (Xc[j], yc[j]))
        f_win, f_full = (float(x) for x in torch.stack(
            [aux["f"], objective(w, full_data)]).double().cpu().numpy())
        trace.meta["host_transfers"] += 1
        for _ in block:
            clock.stochastic_update(batch_size)
        trace.add(step=k_rec, stage=0, window=batch_size, time=clock.time,
                  accesses=clock.data_accesses, f_window=f_win,
                  f_full=f_full)
        start = k_rec + 1
    trace.params = w
    return trace
