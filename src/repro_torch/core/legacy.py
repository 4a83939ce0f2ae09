"""The original host-side BET drivers — the port of
``repro.core.legacy``, preserved for A/B parity.

These are the pre-engine ``run_batch`` / ``run_bet_fixed`` /
``run_two_track`` loops as they shipped: 2–3 blocking device→host pulls
per inner step (the per-step reads of f̂), one per recorded Batch step.
core/engine.py replaces them for production use; they remain so tests can
hold the engine to their trajectories and so the engine-against-legacy
comparison (``chip_smoke.py`` 3r) can measure what the engine saves.

Every device→host read goes through :func:`_pull`, which counts into the
module-level ``HOST_PULLS`` — the comparison's host-sync metric.

Each stage builds a plain closure over its window and steps it eagerly on
the device where the dataset's tensors live: no ``torch.compile``, no CUDA
graph, since the point of these loops is the eager, host-synchronous
baseline.  The reference builds a jitted lambda per stage and so re-traces
every stage; that per-stage re-trace has no counterpart here.  Every
optimizer step computes f̂ and its gradient through the
``linear_value_grad`` kernel (``kernels/ops.py``), as the engine's do.
"""
from __future__ import annotations

import torch

from ..optim.api import BatchOptimizer, Objective
from .engine import BETSchedule
from .timemodel import SimulatedClock
from .trace import Trace

HOST_PULLS = 0


def _pull(x) -> float:
    """``x`` as a Python float with accounting: one blocking device→host
    transfer (``.item()`` of a scalar tensor; a probe may return a float
    already)."""
    global HOST_PULLS
    HOST_PULLS += 1
    return x.item() if isinstance(x, torch.Tensor) else float(x)


def reset_host_pulls() -> None:
    global HOST_PULLS
    HOST_PULLS = 0


def host_pulls() -> int:
    return HOST_PULLS


def _w0(dataset, w0):
    if w0 is not None:
        return w0
    return torch.zeros((dataset.d,), dtype=torch.float32,
                       device=dataset.X.device)


def run_batch(dataset, optimizer: BatchOptimizer, objective: Objective, *,
              steps: int, clock: SimulatedClock | None = None,
              w0=None, record_every: int = 1) -> Trace:
    """Fixed Batch baseline: the inner optimizer on the full dataset."""
    clock = clock or SimulatedClock()
    data = (dataset.X, dataset.y)
    N = dataset.n
    w = _w0(dataset, w0)
    state = optimizer.init(w)

    def step_fn(p, s):
        return optimizer.step(p, s, objective, data)

    trace = Trace("batch", meta={"optimizer": optimizer.name})
    for k in range(steps):
        w, state, aux = step_fn(w, state)
        clock.batch_update(N)
        if k % record_every == 0 or k == steps - 1:
            f = _pull(aux["f"])
            trace.add(step=k, stage=0, window=N, time=clock.time,
                      accesses=clock.data_accesses, f_window=f, f_full=f)
    trace.params = w
    return trace


def run_bet_fixed(dataset, optimizer: BatchOptimizer, objective: Objective, *,
                  schedule: BETSchedule = BETSchedule(),
                  inner_steps: int = 8, final_steps: int = 40,
                  clock: SimulatedClock | None = None, w0=None) -> Trace:
    """Algorithm 1 / 3 as a host-side loop (see core/engine.py for the
    device-side replacement)."""
    clock = clock or SimulatedClock()
    full_data = (dataset.X, dataset.y)
    w = _w0(dataset, w0)
    state = optimizer.init(w)
    trace = Trace("bet", meta={"optimizer": optimizer.name,
                               "inner_steps": inner_steps})
    step_count = 0
    windows = schedule.windows(dataset.n)
    for stage, n_t in enumerate(windows):
        window = dataset.window(n_t)
        state = optimizer.reset_memory(state)   # f̂_t changed; drop memory

        def step_fn(p, s):
            return optimizer.step(p, s, objective, window)

        n_iters = inner_steps if n_t < dataset.n else final_steps
        for _ in range(n_iters):
            w, state, aux = step_fn(w, state)
            clock.batch_update(n_t)
            f_win = _pull(aux["f"])
            f_full = _pull(objective(w, full_data))  # measurement only
            trace.add(step=step_count, stage=stage, window=n_t,
                      time=clock.time, accesses=clock.data_accesses,
                      f_window=f_win, f_full=f_full)
            step_count += 1
    trace.params = w
    return trace


def run_two_track(dataset, optimizer: BatchOptimizer, objective: Objective, *,
                  schedule: BETSchedule = BETSchedule(),
                  final_steps: int = 40, clock: SimulatedClock | None = None,
                  w0=None, charge_condition_eval: bool = True,
                  probe=None) -> Trace:
    """Algorithm 2 as a host-side loop (see core/engine.py for the
    device-side replacement)."""
    clock = clock or SimulatedClock()
    full_data = (dataset.X, dataset.y)
    w = _w0(dataset, w0)
    trace = Trace("bet_two_track", meta={"optimizer": optimizer.name})
    windows = schedule.windows(dataset.n)
    step_count = 0

    for stage in range(1, len(windows)):
        n_prev, n_t = windows[stage - 1], windows[stage]
        win_t, win_prev = dataset.window(n_t), dataset.window(n_prev)
        w_slow, st_slow = w, optimizer.reset_memory(optimizer.init(w))
        w_fast, st_fast = w, optimizer.init(w)

        def slow_step(p, s):
            return optimizer.step(p, s, objective, win_t)

        def fast_step(p, s):
            return optimizer.step(p, s, objective, win_prev)

        def eval_t(p):
            return objective(p, win_t)

        slow_hist = []           # f̂_t(w_{t,k}) for k = 1..s
        s_iter = 0
        max_stage_iters = 500    # safety bound; condition (3) always fires
        while True:
            w_slow, st_slow, aux_s = slow_step(w_slow, st_slow)
            clock.batch_update(n_t)
            w_fast, st_fast, _ = fast_step(w_fast, st_fast)
            clock.batch_update(n_prev)
            s_iter += 1
            slow_hist.append(_pull(aux_s["f"]))
            f_fast_on_t = _pull(eval_t(w_fast))
            if charge_condition_eval:
                clock.eval_pass(n_t)
            f_full = _pull(objective(w_slow, full_data))
            extra = {"f_fast_on_t": f_fast_on_t}
            if probe is not None:
                extra["probe"] = _pull(probe(w_slow))
            trace.add(step=step_count, stage=stage, window=n_t,
                      time=clock.time, accesses=clock.data_accesses,
                      f_window=slow_hist[-1], f_full=f_full, extra=extra)
            step_count += 1
            # condition (3): slow track at ⌊s/2⌋ already beats fast track at s
            k = max(0, s_iter // 2 - 1)
            if (s_iter >= 2 and slow_hist[k] < f_fast_on_t) \
                    or s_iter >= max_stage_iters:
                break
        w = w_slow

    # final phase: full window until budget spent
    full_win = dataset.window(dataset.n)
    state = optimizer.reset_memory(optimizer.init(w))

    def step_fn(p, s):
        return optimizer.step(p, s, objective, full_win)

    for _ in range(final_steps):
        w, state, aux = step_fn(w, state)
        clock.batch_update(dataset.n)
        f = _pull(aux["f"])
        extra = {"probe": _pull(probe(w))} if probe is not None else {}
        trace.add(step=step_count, stage=len(windows), window=dataset.n,
                  time=clock.time, accesses=clock.data_accesses,
                  f_window=f, f_full=f, extra=extra)
        step_count += 1
    trace.params = w
    return trace
