"""Batch-Expansion Training — the paper-named entry points, the port of
``repro.core.bet``.

These are thin, signature-stable wrappers over the unified
:class:`~repro_torch.core.engine.BetEngine`: each pairing of the paper's
algorithms with an inner optimizer is one :class:`ExpansionPolicy`
(``NeverExpand`` = the Batch baseline, ``FixedSteps`` = Alg. 1/3,
``TwoTrack`` = Alg. 2's parameter-free condition (3)) handed to the single
device-side driver in core/engine.py; ``GradientVariance`` is the
beyond-paper gradient-variance trigger.  Each runs where the dataset's
tensors live.

The pre-engine host-side loops live on in core/legacy.py for parity tests
and the engine-against-legacy comparison.

.. deprecated::
    These wrappers are superseded by the declarative front door — build a
    ``repro_torch.api.RunSpec`` (``PolicySpec("two_track")`` etc.) and
    drive it through ``repro_torch.api.build(spec).run()``.  They stay
    bit-exact against the spec-built sessions (tests/test_torch_legacy.py)
    but each call emits a ``DeprecationWarning``.
"""
from __future__ import annotations

import warnings

from ..optim.api import BatchOptimizer, Objective
from .engine import (BETSchedule, BetEngine, FixedSteps, GradientVariance,
                     NeverExpand, TwoTrack)
from .timemodel import SimulatedClock
from .trace import Trace

__all__ = ["BETSchedule", "run_batch", "run_bet_fixed", "run_two_track",
           "run_gradient_variance"]


def _deprecated(fn: str, policy: str) -> None:
    warnings.warn(
        f"repro_torch.core.bet.{fn} is deprecated: build a "
        f"repro_torch.api.RunSpec with PolicySpec({policy!r}) and run it "
        f"through repro_torch.api.build(spec).run()", DeprecationWarning,
        stacklevel=3)


def run_batch(dataset, optimizer: BatchOptimizer, objective: Objective, *,
              steps: int, clock: SimulatedClock | None = None,
              w0=None, record_every: int = 1) -> Trace:
    """Fixed Batch baseline: the inner optimizer on the full dataset."""
    _deprecated("run_batch", "batch")
    policy = NeverExpand(steps=steps, record_every=record_every)
    return BetEngine().run(dataset, optimizer, objective, policy,
                           w0=w0, clock=clock, trace_name="batch")


def run_bet_fixed(dataset, optimizer: BatchOptimizer, objective: Objective, *,
                  schedule: BETSchedule = BETSchedule(),
                  inner_steps: int = 8, final_steps: int = 40,
                  clock: SimulatedClock | None = None, w0=None) -> Trace:
    """Algorithm 1 / 3: fixed κ̂ inner iterations per stage, window doubling.

    ``inner_steps`` plays the role of κ̂ = ⌈κ log 6⌉; Theorem 4.1 sets it from
    the inner optimizer's rate κ, in practice a small constant (§4.2: 2–4).
    ``final_steps`` continues on the full window until the step budget is
    spent (the `while stopping condition not met` tail of Alg. 2/3).
    """
    _deprecated("run_bet_fixed", "fixed_steps")
    policy = FixedSteps(inner_steps=inner_steps, final_steps=final_steps)
    return BetEngine(schedule=schedule).run(
        dataset, optimizer, objective, policy, w0=w0, clock=clock,
        trace_name="bet", meta={"inner_steps": inner_steps})


def run_two_track(dataset, optimizer: BatchOptimizer, objective: Objective, *,
                  schedule: BETSchedule = BETSchedule(),
                  final_steps: int = 40, clock: SimulatedClock | None = None,
                  w0=None, charge_condition_eval: bool = True,
                  probe=None) -> Trace:
    """Algorithm 2: the parameter-free Two-Track controller.

    Primary (slow) track runs on n_t; secondary (fast) track on n_{t-1} from
    the same stage-start point.  Expansion triggers when
    f̂_t(w_{t,⌊s/2⌋}) < f̂_t(w'_{t-1,s})  — condition (3).  Per the paper, one
    secondary step is run per primary step (not two), trading a slightly later
    trigger for less overhead.
    """
    _deprecated("run_two_track", "two_track")
    policy = TwoTrack(final_steps=final_steps,
                      charge_condition_eval=charge_condition_eval)
    return BetEngine(schedule=schedule).run(
        dataset, optimizer, objective, policy, w0=w0, clock=clock,
        probe=probe, trace_name="bet_two_track")


def run_gradient_variance(dataset, optimizer: BatchOptimizer,
                          objective: Objective, *,
                          schedule: BETSchedule = BETSchedule(),
                          theta: float = 0.5, final_steps: int = 40,
                          clock: SimulatedClock | None = None,
                          w0=None, **policy_kw) -> Trace:
    """Beyond-paper: the DSM/AdaDamp gradient-variance trigger on BET's
    resampling-free expanding window (see engine.GradientVariance)."""
    _deprecated("run_gradient_variance", "gradient_variance")
    policy = GradientVariance(theta=theta, final_steps=final_steps,
                              **policy_kw)
    return BetEngine(schedule=schedule).run(
        dataset, optimizer, objective, policy, w0=w0, clock=clock,
        meta={"theta": theta})
