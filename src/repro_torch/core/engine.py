"""Unified Batch-Expansion Training engine — the port of
``repro.core.engine``.

The *when-to-expand* decision is orthogonal to the *how-to-step* loop:

  * ``ExpansionPolicy`` — ``stage_begin`` / ``plan_steps`` /
    ``should_expand`` / ``stage_end``.  Ported policies:

      - ``FixedSteps``        Algorithm 1/3: κ̂ inner iterations per stage,
      - ``TwoTrack``          Algorithm 2: the parameter-free condition (3),
      - ``NeverExpand``       the Batch baseline (one full-window stage),
      - ``GradientVariance``  beyond-paper: the Byrd et al. (2012) /
                              AdaDamp-style norm test on BET's
                              resampling-free expanding window,
      - ``ComposedPolicy``    veto (AND) / any_of (OR) composition.

  * ``BetEngine.run(dataset, optimizer, objective, policy, ...)`` — the
    one driver.

Stages run on the device.  A scan stage's chunk is a Python loop of
optimizer steps (each free of host syncs) that writes f̂_t(w) and f̂(w)
into preallocated device tensors; the host pulls them with one transfer
per chunk (``trace.meta["host_transfers"]`` counts the pulls), then replays
the §4.2 clock charges.  A policy that ``wants_variance`` gets the
gradient-variance statistics of the chunk's last point in the same pull.

A Two-Track racing stage leaves the device once, as the reference's
``lax.while_loop`` does: the first race step runs eagerly (condition (3)
cannot fire before the second, and the step warms up the kernels and the
allocator), then the race step is captured once and repeated by a CUDA
graph's WHILE node until condition (3) fires or ``max_stage_iters`` steps
have run (``kernels/device_while.py``; on the CPU the same step runs in a
plain loop).  Each step writes f̂ into device histories at the device
step index ``s``; one pull then brings the histories, ``s`` and the
trigger flag (and the slow track's parameters when a probe wants them).
The slow carry left on the device is the trigger step's, so nothing runs
past the trigger: ``trace.meta["race_overshoot"]`` stays 0 (the key is
kept for checkpoints).  A policy that wants the variance test (a
``GradientVariance`` veto) gets one more pull after each race round, as
in the reference.

A captured graph is kept for the next race round (a veto's re-race, or
the next stage) while what it baked in holds: the same optimizer,
objective, policy and step budget, carries of the same shapes, and
windows that are the same tensors.  A window's device scalars (a
``MaskedWindow``'s valid length) are read through scalars the graph owns,
so the plane's fixed-shape windows replay one graph over every racing
stage; the host path's windows change shape each stage, and each stage
captures its own.  A replayed round starts at step 1 inside the graph.
A stage hands on copies of the graph's carries, since the next round
writes them, and the graph is freed before the final phase.

Parameters and optimizer states may be single tensors (the convex path) or
nested dicts of tensors (the LM path); optimizers are functional (a step
returns new tensors), so both tracks can start from one ``w``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..data.device_window import MaskedWindow
from ..kernels import ops
from ..optim.api import BatchOptimizer, Objective, tree_leaves, tree_map
from .timemodel import SimulatedClock
from .trace import Trace


# ------------------------------------------------------------------ schedule
@dataclasses.dataclass(frozen=True)
class BETSchedule:
    """Stage schedule: n_{t+1} = growth * n_t (paper: growth=2, §3.5 notes the
    factor is not critical), ε_{t+1} = ε_t / growth."""
    n0: int = 200
    growth: float = 2.0

    def __post_init__(self):
        if self.n0 < 1:
            raise ValueError(f"BETSchedule.n0 must be >= 1, got {self.n0}")
        if not self.growth > 1.0:
            raise ValueError(
                f"BETSchedule.growth must be > 1, got {self.growth}: the "
                "window n_t = n0 * growth^t would never reach the dataset")

    def windows(self, N: int) -> list[int]:
        ns, n = [], self.n0
        while n < N:
            ns.append(n)
            n = min(N, int(math.ceil(n * self.growth)))
        ns.append(N)
        return ns


# ------------------------------------------------------------- resume/hooks
@dataclasses.dataclass(frozen=True)
class ResumeState:
    """Where a checkpointed run left off.  ``next_stage`` is the first stage
    index to execute; the counters seed the engine context so step
    numbering, stage counts, transfer and overshoot accounting continue
    exactly where the uninterrupted run would be (Thm 4.1 bookkeeping
    survives the restart).  The caller restores params, optimizer state,
    clock and meters separately (elastic/checkpoint.py bundles all of
    it)."""
    next_stage: int
    step_count: int = 0
    stages: int = 0
    transfers: int = 0
    overshoot: int = 0


@dataclasses.dataclass
class StageEnd:
    """What the once-per-stage boundary hook sees: the stage, the carries
    the next stage starts from, the clock, the dataset and the live
    trace."""
    info: "StageInfo"
    params: Any
    opt_state: Any
    clock: SimulatedClock
    dataset: Any
    trace: Trace
    step_count: int
    stages: int
    transfers: int
    overshoot: int = 0


# ------------------------------------------------------------------ protocol
@dataclasses.dataclass
class StageInfo:
    """What a policy sees about the current stage.  ``n_next`` is the
    window the schedule will expand to afterwards (None on the last
    stage)."""
    stage: int
    n_t: int
    n_prev: int
    is_final: bool
    N: int
    n_next: int | None = None


class StageRecords:
    """Host-side accumulator for one stage's transferred measurements."""

    def __init__(self):
        self._f_window: list[np.ndarray] = []
        self._f_full: list[np.ndarray] = []
        self._params: list[np.ndarray] = []   # per-chunk (steps, d) params
        self.f_fast_on_t: np.ndarray | None = None   # two-track only
        self.triggered: bool = False                  # two-track condition (3)
        self.var: float = 0.0                         # gradient-variance stats
        self.g2: float = 0.0

    def add_chunk(self, f_window, f_full=None, params=None):
        self._f_window.append(np.asarray(f_window))
        if f_full is not None:
            self._f_full.append(np.asarray(f_full))
        if params is not None:
            self._params.append(params)

    @property
    def steps(self) -> int:
        return sum(len(c) for c in self._f_window)

    def chunk_lengths(self) -> list[int]:
        return [len(c) for c in self._f_window]

    def f_window(self) -> np.ndarray:
        return np.concatenate(self._f_window) if self._f_window else np.empty(0)

    def f_full(self) -> np.ndarray:
        if not self._f_full:
            return self.f_window()          # policy opted out of full evals
        return np.concatenate(self._f_full)

    def param_at(self, i: int):
        """The (host) parameters after inner step ``i`` of this stage."""
        for chunk in self._params:
            n = len(tree_leaves(chunk)[0])
            if i < n:
                return tree_map(lambda a: a[i], chunk)
            i -= n
        raise IndexError(i)


class ExpansionPolicy:
    """When-to-expand protocol.  The engine owns stepping, clock accounting
    and tracing; the policy only answers scheduling questions:

      stage_begin(info)            — a new window n_t is about to run
      plan_steps(info, done)       — how many inner steps to run before the
                                     next should_expand consultation
      should_expand(info, records) — stage over?  (records hold everything
                                     transferred so far this stage)
      stage_end(info, records)     — the stage finished

    ``kind == "two_track"`` routes stages through the race (the trigger
    then fires inside it and ``should_expand`` just confirms it); every
    other policy runs chunks of steps.
    """
    name = "policy"
    kind = "scan"               # "scan" | "two_track"
    eval_full = True            # evaluate f̂(w) per step (False: f_full := f_window)
    wants_variance = False      # compute per-example gradient-variance stats
    record_every = 1
    probe = 0

    def windows(self, schedule: BETSchedule, N: int) -> list[int]:
        return schedule.windows(N)

    def stage_begin(self, info: StageInfo) -> None:
        pass

    def plan_steps(self, info: StageInfo, done_steps: int) -> int:
        raise NotImplementedError

    def should_expand(self, info: StageInfo, records: StageRecords) -> bool:
        return True

    def stage_end(self, info: StageInfo, records: StageRecords) -> None:
        pass


@dataclasses.dataclass
class FixedSteps(ExpansionPolicy):
    """Algorithm 1/3: a fixed κ̂ inner iterations per stage, ``final_steps``
    on the full window (Theorem 4.1 sets κ̂ from the inner rate; §4.2: 2–4)."""
    inner_steps: int = 8
    final_steps: int = 40
    name = "bet"

    def plan_steps(self, info, done_steps):
        return self.final_steps if info.is_final else self.inner_steps


@dataclasses.dataclass
class NeverExpand(ExpansionPolicy):
    """The Batch baseline: a single stage on the full dataset."""
    steps: int = 30
    record_every: int = 1
    eval_full: bool = False     # window == full data; legacy records f_full := f
    name = "batch"

    def windows(self, schedule, N):
        return [N]

    def plan_steps(self, info, done_steps):
        return self.steps


@dataclasses.dataclass
class TwoTrack(ExpansionPolicy):
    """Algorithm 2: primary (slow) track on n_t races a secondary (fast)
    track on n_{t-1} from the same stage-start point; expansion triggers on
    condition (3): f̂_t(w_{t,⌊s/2⌋}) < f̂_t(w'_{t-1,s}).  Parameter-free.

    ``condition="aux"`` compares the slow track's own per-step objective
    (the convex drivers); ``condition="eval"`` re-evaluates the slow track
    on the stage window."""
    final_steps: int = 40
    max_stage_iters: int = 500          # safety bound; condition (3) always fires
    charge_condition_eval: bool = True
    condition: str = "aux"              # "aux" | "eval"
    final_eval_full: bool = False       # legacy final phase records f_full := f
    name = "bet_two_track"
    kind = "two_track"

    def plan_steps(self, info, done_steps):        # final phase only
        return self.final_steps

    def should_expand(self, info, records):
        if records.f_fast_on_t is not None:   # racing stage: in-race trigger
            return records.triggered or records.steps >= self.max_stage_iters
        return records.steps >= self.final_steps    # final phase budget spent


@dataclasses.dataclass
class GradientVariance(ExpansionPolicy):
    """Beyond-paper adaptive trigger: the gradient-variance "norm test" of
    DSM (Byrd, Chin, Nocedal, Wu 2012) / AdaDamp (Alfarra et al.), applied
    to BET's *resampling-free* expanding window.  After each chunk the
    engine measures, on a ``probe``-point prefix of the resident window,

        v = ‖Var_i ∇ℓ_i(w)‖₁ / k     vs     g² = ‖∇f̂_t(w)‖² ;

    once noise dominates signal (v > θ² g²) the window's gradient has no
    more to teach and the stage ends.  Unlike DSM this touches no new data
    until the expansion itself, so Thm 4.1's access bound still applies.
    Requires ``data = (X, y)`` with per-example rows (the convex path)."""
    theta: float = 0.5
    probe: int = 256
    chunk: int = 4
    min_stage_steps: int = 2
    max_stage_iters: int = 64
    final_steps: int = 40
    name = "bet_gradvar"
    wants_variance = True

    def plan_steps(self, info, done_steps):
        return self.final_steps if info.is_final else self.chunk

    def should_expand(self, info, records):
        if info.is_final or records.steps >= self.max_stage_iters:
            return True
        if records.steps < self.min_stage_steps:
            return False
        return records.var > (self.theta ** 2) * max(records.g2, 1e-30)


class ComposedPolicy(ExpansionPolicy):
    """Policy composition: one primary policy owns the stage loop shape
    (chunks or the two-track race) and the expansion proposal; ``vetoes``
    must all concur before an expansion is allowed (logical AND);
    ``any_of`` may force an expansion the primary has not proposed yet
    (logical OR).  Only the primary slot may be two_track-kind (the race
    cannot run as a veto); the engine re-races a stage a veto holds open.
    Unknown attributes delegate to the primary."""

    def __init__(self, primary: ExpansionPolicy, vetoes=(), any_of=()):
        self.primary = primary
        self.vetoes = tuple(vetoes)
        self.any_of = tuple(any_of)
        members = (primary,) + self.vetoes + self.any_of
        for p in self.vetoes + self.any_of:
            if p.kind != "scan":
                raise ValueError(
                    f"policy {p.name!r} is {p.kind!r}-kind: only the "
                    f"primary slot of a ComposedPolicy may be two_track "
                    f"(the race kernel cannot run as a veto)")
        self.name = "composed(" + "+".join(p.name for p in members) + ")"
        self.kind = primary.kind
        self.eval_full = primary.eval_full
        self.record_every = primary.record_every
        self.wants_variance = any(p.wants_variance for p in members)
        self.probe = max((int(p.probe) for p in members), default=0)

    def __getattr__(self, item):
        if item == "primary":           # guard pre-__init__ lookups
            raise AttributeError(item)
        return getattr(self.primary, item)

    def windows(self, schedule: BETSchedule, N: int) -> list[int]:
        return self.primary.windows(schedule, N)

    def stage_begin(self, info: StageInfo) -> None:
        for p in (self.primary,) + self.vetoes + self.any_of:
            p.stage_begin(info)

    def plan_steps(self, info: StageInfo, done_steps: int) -> int:
        return self.primary.plan_steps(info, done_steps)

    def should_expand(self, info: StageInfo, records: StageRecords) -> bool:
        if any(p.should_expand(info, records) for p in self.any_of):
            return True
        if not self.primary.should_expand(info, records):
            return False
        return all(p.should_expand(info, records) for p in self.vetoes)

    def stage_end(self, info: StageInfo, records: StageRecords) -> None:
        for p in (self.primary,) + self.vetoes + self.any_of:
            p.stage_end(info, records)


def variance_stats(objective: Objective, w, data, k: int):
    """(‖Var_i ∇ℓ_i‖₁ / k, ‖ḡ‖²) over the first ``k`` rows of (X, y) — the
    DSM / GradientVariance test, as device tensors.  The per-example
    gradients (of f̂ on one-row windows) come in closed form from the
    objective; their common λw term is in ḡ and cancels in the variance."""
    X, y = data
    gs = objective.example_grads(w, (X[:k], y[:k]))        # (k, d)
    gbar = torch.mean(gs, dim=0)
    v = torch.sum(torch.mean((gs - gbar) ** 2, dim=0)) / k
    return v, torch.sum(gbar ** 2)


def _host(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: such leaves come back widened to float32
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _pull(ctx, tensors: dict) -> dict:
    """One device-to-host transfer of a chunk's records (the reference's
    one ``jax.device_get`` of a dict), counted in ``host_transfers`` and,
    with a recorder, emitted as ``engine.transfer``."""
    out = tree_map(_host, tensors)
    ctx["transfers"] += 1
    if ctx["obs"] is not None:
        ctx["obs"].instant("engine.transfer", transfers=ctx["transfers"])
    return out


def _obs_span(recorder, name: str, **fields):
    """A recorder span when a recorder is wired, a no-op otherwise: every
    engine hook is one ``None`` check without one."""
    if recorder is None:
        return contextlib.nullcontext({})
    return recorder.span(name, **fields)


def _param_buffer(w, k: int):
    """Device buffers for ``k`` steps of parameters shaped like ``w``."""
    return tree_map(lambda x: torch.empty((k,) + tuple(x.shape),
                                          dtype=x.dtype, device=x.device), w)


def _store(buf, s, w) -> None:
    """Write step ``s``'s parameters into the buffers of ``_param_buffer``;
    ``s`` is a host index or a device step index (a 0-d int64 tensor)."""
    def put(b, x):
        if isinstance(s, torch.Tensor):
            b.index_copy_(0, s.view(1), x.unsqueeze(0))
        else:
            b[s] = x
    tree_map(put, buf, w)


def _signature(x, *, addresses: bool):
    """What a captured race step bakes in from ``x``: the tree's
    structure, each tensor's shape, dtype and device, and, with
    ``addresses``, each tensor's memory (a 0-d tensor is staged, see
    ``_stage_scalars``, and is matched by dtype and device alone); a
    ``MaskedWindow`` by its fields, host values by value, any other object
    by identity (the race graph holds it, so the identity stays its
    own)."""
    if isinstance(x, torch.Tensor):
        sig = (tuple(x.shape), x.dtype, x.device)
        if addresses and x.dim():
            sig += (x.data_ptr(), x.stride())
        return sig
    if isinstance(x, dict):
        return tuple((k, _signature(v, addresses=addresses))
                     for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_signature(v, addresses=addresses)
                                  for v in x)
    if isinstance(x, MaskedWindow):
        return (MaskedWindow, _signature(x.data, addresses=addresses),
                _signature(x.n_valid, addresses=addresses))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return ("object", id(x))


def _map_scalars(fn, x):
    """``x`` with ``fn`` applied to each 0-d tensor of its tuples, lists
    and ``MaskedWindow``s."""
    if isinstance(x, torch.Tensor) and x.dim() == 0:
        return fn(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_map_scalars(fn, v) for v in x)
    if isinstance(x, MaskedWindow):
        return MaskedWindow(x.data, _map_scalars(fn, x.n_valid))
    return x


def _stage_scalars(x, scalars: list):
    """``x`` with each 0-d tensor of ``_map_scalars`` replaced by a copy,
    appended to ``scalars``: a graph captured on the copies reads a later
    window's scalars once they are copied in."""
    def stage(t):
        scalars.append(t.clone())
        return scalars[-1]
    return _map_scalars(stage, x)


def _window_scalars(x) -> list:
    """The 0-d tensors of ``x`` in ``_stage_scalars``' order."""
    out: list = []
    _map_scalars(out.append, x)
    return out


@dataclasses.dataclass
class _RaceGraph:
    """A captured race loop kept for later rounds: its launch, the device
    buffers it writes (``hist``, ``s``, ``triggered`` and, with a probe,
    ``W``), the window scalars it reads, and what it baked in (``key``;
    ``held`` keeps the objects the key names by identity alive)."""
    key: tuple
    loop: Any
    bufs: dict
    scalars: list
    held: tuple


def race_step_fns(optimizer, objective, policy, win_t, win_prev, full_data,
                  hist, s, W=None):
    """The race's step functions over one stage's windows: ``race_tracks``
    (both tracks' step and the step's three f̂) and ``race_step`` (that,
    with f̂ written into the histories ``hist`` (3, max_iters), and the
    slow track's parameters into ``W`` when given, at the device step
    index ``s``) — the step the WHILE graph captures."""
    def race_tracks(carry: list, win_t, win_prev, full_data):
        """Both tracks' step from ``carry`` ([w_slow, st_slow, w_fast,
        st_fast]), replaced in the list as each track steps, so an old
        carry is dropped as soon as its successor exists; returns the list
        and the step's three f̂ (slow on the window, fast on the window,
        slow on the full data)."""
        carry[0], carry[1], aux = optimizer.step(carry[0], carry[1],
                                                 objective, win_t)
        carry[2], carry[3], _ = optimizer.step(carry[2], carry[3],
                                               objective, win_prev)
        f_slow = objective(carry[0], win_t) \
            if policy.condition == "eval" else aux["f"]
        return carry, torch.stack([f_slow.float(),
                                   objective(carry[2], win_t).float(),
                                   objective(carry[0], full_data).float()])

    def race_step(carry: list) -> list:
        carry, row = race_tracks(carry, win_t, win_prev, full_data)
        hist.index_copy_(1, s.view(1), row.view(3, 1))
        if W is not None:
            _store(W, s, carry[0])
        return carry

    return race_tracks, race_step


# ---------------------------------------------------------------- the engine
@dataclasses.dataclass
class BetEngine:
    """The single BET driver.  Policies decide *when* to expand; the engine
    owns stepping (on the device), clock accounting (host replay of the
    §4.2 charges after each pull) and tracing.

    ``step_cost`` maps the stage window n_t to the points one inner step
    charges the clock (default: the whole window).  ``wait_on_expand``
    blocks the clock on window residency at stage entry;
    ``carry_state`` keeps optimizer state across Two-Track stages instead
    of re-initializing.

    ``recorder`` (an ``obs.EventRecorder``) makes the engine emit the
    reference's structured events: per stage ``stage.begin``, the
    ``stage.acquire``, ``stage.compute`` and ``stage.flush`` spans,
    ``engine.transfer`` per pull, ``expand.decision`` per policy
    consultation, the ``stage.totals`` counter and ``stage.end``.
    ``profiler`` (an ``obs.profile.StageProfiler``) costs each stage's
    step once before the stage's first step, on meta tensors.  Both off by
    default; the trajectory is bit-identical either way."""
    schedule: BETSchedule = dataclasses.field(default_factory=BETSchedule)
    step_cost: Callable[[int], int] | None = None
    wait_on_expand: bool = False
    carry_state: bool = False
    max_engine_steps: int = 100_000     # runaway-policy backstop
    # once-per-stage boundary callback (StageEnd)
    stage_callback: Callable | None = None
    recorder: Any | None = None
    profiler: Any | None = None
    # the seconds each race round of the last run spent capturing its
    # WHILE graph (0.0 for the plain loop on the CPU)
    race_capture_s: list = dataclasses.field(default_factory=list,
                                             repr=False)

    def run(self, dataset, optimizer: BatchOptimizer, objective: Objective,
            policy: ExpansionPolicy, *, w0=None, clock: SimulatedClock | None = None,
            eval_data=None, probe: Callable | None = None,
            trace_name: str | None = None, meta: dict | None = None,
            progress: Callable | None = None, opt_state0=None,
            resume: ResumeState | None = None) -> Trace:
        clock = clock or SimulatedClock()
        N = dataset.n
        # NB: with a StreamingDataset, omitting eval_data forces the whole
        # corpus resident here (f̂ needs all N points) and defeats staged
        # loading — pass an eval set/probe to keep the plane streaming.
        full_data = eval_data if eval_data is not None else dataset.window(N)
        w = w0 if w0 is not None else torch.zeros(
            (dataset.d,), dtype=torch.float32, device=full_data[0].device)
        state = optimizer.init(w) if opt_state0 is None else dict(opt_state0)
        trace = Trace(trace_name or policy.name,
                      meta={"engine": "BetEngine", "policy": policy.name,
                            "optimizer": optimizer.name, **(meta or {})})
        ctx = self._context(trace, clock, probe, progress, dataset)
        first_stage = 0
        if resume is not None:
            ctx.update(step_count=resume.step_count,
                       transfers=resume.transfers, stages=resume.stages,
                       overshoot=resume.overshoot)
            first_stage = resume.next_stage
            trace.meta["resumed_from_stage"] = first_stage - 1

        # the live carry: only this list holds it, so each step's output
        # replaces its input and no earlier carry stays referenced
        carry = [w, state]
        del w, state
        if policy.kind == "two_track":
            self._run_two_track(ctx, dataset, optimizer, objective, policy,
                                carry, full_data, first_stage=first_stage)
        else:
            for info in self.stage_infos(policy, N):
                if info.stage < first_stage:
                    continue            # completed before the checkpoint
                carry[1] = optimizer.reset_memory(carry[1])  # f̂_t changed
                self._run_scan_stage(ctx, dataset, optimizer, objective,
                                     policy, info, carry, full_data)
        trace.params = carry[0]
        trace.meta["host_transfers"] = ctx["transfers"]
        trace.meta["race_overshoot"] = ctx["overshoot"]
        trace.meta["stages"] = ctx["stages"]
        self.race_capture_s = ctx["capture_s"]
        return trace

    def _context(self, trace, clock, probe, progress, dataset) -> dict:
        """A run's mutable state, shared by its stages."""
        return {"trace": trace, "clock": clock,
                "cost": self.step_cost or (lambda n: n), "probe": probe,
                "progress": progress, "dataset": dataset,
                "obs": self.recorder, "step_count": 0, "transfers": 0,
                "stages": 0, "overshoot": 0, "capture_s": [],
                "race_graph": None}

    # ------------------------------------------------------------ online runs
    def run_online(self, dataset, optimizer: BatchOptimizer,
                   objective: Objective, policy: ExpansionPolicy, *,
                   source=None, w0=None, clock: SimulatedClock | None = None,
                   eval_data=None, probe: Callable | None = None,
                   trace_name: str | None = None, meta: dict | None = None,
                   progress: Callable | None = None, opt_state0=None,
                   max_stages: int = 10_000) -> Trace:
        """``run`` over a corpus still *arriving* (serve-while-you-train).

        ``run`` precomputes the stage plan from ``dataset.n`` once; here
        the corpus size is discovered as the serving path logs requests, so
        the stage plan is built one stage at a time: each stage targets
        ``n_next = ceil(growth * n_t)`` and the policy (normally
        ``serve.policy.TrafficDriven``) *holds the stage open* — more inner
        steps on the current window — until enough new examples have been
        sealed to honor that target, or the ``source`` store closes.  Once
        the source is closed and the window covers everything sealed, one
        final full-window stage runs and the loop ends.

        ``eval_data`` is required: with the corpus still arriving there is
        no full-window f̂ to fall back to.  Two-track policies are rejected
        — the race needs the *next* window resident up front, which is
        exactly what an online corpus cannot promise.  ``w0`` and
        ``opt_state0`` are copied: the run never writes into, or hands
        out, the caller's tensors (a server may be serving them).
        """
        if eval_data is None:
            raise ValueError(
                "run_online requires eval_data: the full corpus is not "
                "available for f̂ while data is still arriving")
        if policy.kind == "two_track":
            raise ValueError(
                f"policy {policy.name!r} is two_track-kind: the race needs "
                f"next-window residency up front; run_online supports only "
                f"scan policies")
        if dataset.n < 1:
            raise ValueError(
                "run_online needs at least one sealed example before "
                "training starts (seed the source first)")
        clock = clock or SimulatedClock()

        def copy(x):
            return x.clone() if isinstance(x, torch.Tensor) else x
        w = tree_map(copy, w0) if w0 is not None else torch.zeros(
            (dataset.d,), dtype=torch.float32, device=eval_data[0].device)
        state = optimizer.init(w) if opt_state0 is None else \
            tree_map(copy, opt_state0)
        trace = Trace(trace_name or policy.name,
                      meta={"engine": "BetEngine.online",
                            "policy": policy.name,
                            "optimizer": optimizer.name, **(meta or {})})
        ctx = self._context(trace, clock, probe, progress, dataset)
        carry = [w, state]
        del w, state
        growth = self.schedule.growth
        stage = 0
        n_t = min(self.schedule.n0, dataset.n)
        n_prev = n_t
        while True:
            closed = bool(getattr(source, "closed", True))
            is_final = closed and n_t >= dataset.n
            n_next = None if is_final else \
                max(n_t + 1, int(math.ceil(n_t * growth)))
            info = StageInfo(stage=stage, n_t=n_t, n_prev=n_prev,
                             is_final=is_final, N=dataset.n, n_next=n_next)
            carry[1] = optimizer.reset_memory(carry[1])
            self._run_scan_stage(ctx, dataset, optimizer, objective, policy,
                                 info, carry, eval_data)
            if is_final:
                break
            # the stage was held open until the target (or close) landed;
            # clip to what is actually sealed now
            n_prev, n_t = n_t, min(dataset.n, n_next)
            stage += 1
            if stage > max_stages:
                raise RuntimeError(
                    f"run_online exceeded {max_stages} stages without the "
                    f"source closing")
        trace.params = carry[0]
        trace.meta["host_transfers"] = ctx["transfers"]
        trace.meta["stages"] = ctx["stages"]
        trace.meta["final_n"] = dataset.n
        return trace

    # ---------------------------------------------------------- stage windows
    def stage_infos(self, policy: ExpansionPolicy, N: int) -> list[StageInfo]:
        """The stages a run of ``policy`` over ``N`` examples executes, in
        order.  Two-track runs race stages 1..T over consecutive window
        pairs, then a final full-window phase; scan policies run one stage
        per window."""
        windows = policy.windows(self.schedule, N)
        if policy.kind == "two_track":
            infos = [StageInfo(stage=stage, n_t=windows[stage],
                               n_prev=windows[stage - 1],
                               is_final=windows[stage] >= N, N=N,
                               n_next=windows[stage + 1]
                               if stage + 1 < len(windows) else None)
                     for stage in range(1, len(windows))]
            infos.append(StageInfo(stage=len(windows), n_t=N, n_prev=N,
                                   is_final=True, N=N))
            return infos
        return [StageInfo(stage=stage, n_t=n_t,
                          n_prev=windows[stage - 1] if stage else n_t,
                          is_final=n_t >= N, N=N,
                          n_next=windows[stage + 1]
                          if stage + 1 < len(windows) else None)
                for stage, n_t in enumerate(windows)]

    @staticmethod
    def _acquire_window(dataset, n_t: int, n_next: int | None):
        """Stage setup against the data plane: a ``StreamingDataset`` makes
        the stage window device-resident and starts prefetching the *next*
        expansion's shards (so their loads overlap this stage's compute);
        plain datasets fall back to the host-slice window protocol."""
        begin = getattr(dataset, "begin_stage", None)
        if begin is not None:
            return begin(n_t, n_next)
        return dataset.window(n_t)

    @staticmethod
    def _segment_plan(dataset, info: StageInfo, k: int):
        """Chunk plan against the data plane: a tiered corpus whose stage
        window exceeds the HBM budget splits the chunk's ``k`` steps across
        its hot-window sweep (``[(steps, examples_per_step), ...]`` — the
        engine calls ``advance_window`` between entries); every other plane
        runs the chunk in one piece at full window cost (``None`` ->
        ``info.n_t``)."""
        plan = getattr(dataset, "segment_steps", None)
        if plan is None:
            return [(k, None)]
        return plan(info.n_t, k)

    @staticmethod
    def _note_access(ctx, examples: int) -> None:
        """Report optimizer touches to the data plane's DataAccessMeter, in
        the same units the SimulatedClock charges — real-read accounting."""
        note = getattr(ctx["dataset"], "note_access", None)
        if note is not None and examples:
            note(examples)

    # ------------------------------------------------------------ scan stages
    def _run_chunk(self, ctx, optimizer, objective, carry: list, win,
                   full_data, k: int, *, eval_full: bool, probe_k: int = 0):
        """``k`` inner steps on ``win`` from ``carry`` ([w, state], updated
        in place); per-step records land in device buffers and come back
        in one pull, with the variance statistics of the last point on a
        ``probe_k``-row prefix of ``win`` when ``probe_k`` > 0."""
        dev = tree_leaves(carry[0])[0].device
        bufs = {"f": torch.empty((k,), dtype=torch.float32, device=dev)}
        if eval_full:
            bufs["f_full"] = torch.empty((k,), dtype=torch.float32, device=dev)
        if ctx["probe"] is not None:
            bufs["w"] = _param_buffer(carry[0], k)
        for j in range(k):
            w, state, aux = optimizer.step(*carry, objective, win)
            carry[:] = (w, state)
            bufs["f"][j] = aux["f"]
            if eval_full:
                bufs["f_full"][j] = objective(carry[0], full_data)
            if "w" in bufs:
                _store(bufs["w"], j, carry[0])
        if probe_k:
            bufs["var"], bufs["g2"] = variance_stats(objective, carry[0], win,
                                                     probe_k)
        return _pull(ctx, bufs)

    def _run_scan_stage(self, ctx, dataset, optimizer, objective, policy,
                        info: StageInfo, carry: list, full_data, *,
                        eval_full=None):
        """One stage from ``carry`` ([w, state], updated in place)."""
        eval_full = policy.eval_full if eval_full is None else eval_full
        obs = ctx["obs"]
        if obs is not None:
            obs.set_context(stage=info.stage)
            obs.instant("stage.begin", window=info.n_t, n_next=info.n_next,
                        final=info.is_final)
        with _obs_span(obs, "stage.acquire", window=info.n_t):
            win = self._acquire_window(dataset, info.n_t, info.n_next)
        if self.wait_on_expand:
            ctx["clock"].wait_for(info.n_t)
        probe_k = min(int(policy.probe), info.n_t) \
            if policy.wants_variance else 0
        policy.stage_begin(info)
        rec = StageRecords()
        if self.profiler is not None:
            def scan_step(w, state, data):
                return optimizer.step(w, state, objective, data)
            self.profiler.observe(info, scan_step, (carry[0], carry[1], win),
                                  {})
        chunk_costs: list = []
        while True:
            k = int(policy.plan_steps(info, rec.steps))
            for seg_j, (kj, seg_n) in enumerate(
                    self._segment_plan(dataset, info, k)):
                if seg_j:
                    # rotation: land the next pre-staged sweep segment
                    with _obs_span(obs, "stage.acquire", window=info.n_t,
                                   segment=seg_n):
                        win = dataset.advance_window()
                pk = probe_k if seg_n is None else min(probe_k, seg_n)
                with _obs_span(obs, "stage.compute", steps=kj,
                               window=info.n_t):
                    pulled = self._run_chunk(ctx, optimizer, objective,
                                             carry, win, full_data, kj,
                                             eval_full=eval_full, probe_k=pk)
                rec.add_chunk(pulled["f"], pulled.get("f_full"),
                              pulled.get("w"))
                chunk_costs.append(seg_n)
            if probe_k:
                rec.var, rec.g2 = float(pulled["var"]), float(pulled["g2"])
            expand = policy.should_expand(info, rec)
            if obs is not None:
                fs = pulled["f"]
                obs.instant("expand.decision", expand=bool(expand),
                            window=info.n_t, steps=rec.steps, var=rec.var,
                            g2=rec.g2, triggered=bool(rec.triggered),
                            f_last=float(fs[-1]) if len(fs) else None)
            if expand:
                break
            if rec.steps > self.max_engine_steps:
                raise RuntimeError(
                    f"policy {policy.name} never expanded after {rec.steps} steps")
        with _obs_span(obs, "stage.flush", window=info.n_t):
            self._flush_stage(ctx, policy, info, rec, eval_charge=probe_k,
                              chunk_costs=chunk_costs)
        policy.stage_end(info, rec)
        self._stage_boundary(ctx, info, *carry)
        if obs is not None:
            obs.instant("stage.end", window=info.n_t)
            obs.clear_context("stage")

    def _stage_boundary(self, ctx, info: StageInfo, w, state) -> None:
        """Once-per-stage boundary: the stage's records are flushed, the
        trace is current, and (w, state) are the exact carries the next
        stage starts from — where a checkpoint captures a resumable run and
        where elastic events (host loss and join, straggler rebalancing)
        are applied between stages (``elastic/runtime.py``)."""
        if self.stage_callback is not None:
            self.stage_callback(StageEnd(
                info=info, params=w, opt_state=state, clock=ctx["clock"],
                dataset=ctx["dataset"], trace=ctx["trace"],
                step_count=ctx["step_count"], stages=ctx["stages"],
                transfers=ctx["transfers"], overshoot=ctx["overshoot"]))

    def _collect_host_records(self, ctx, info: StageInfo) -> None:
        """Once-per-stage flush hook, called right before the trace lands.
        The multi-host runtime (``dist/runtime.DistributedBetEngine``)
        all-gathers per-host stage records here through its communicator;
        the single-host engine records nothing extra."""

    def _flush_stage(self, ctx, policy, info: StageInfo, rec: StageRecords,
                     *, eval_charge: int = 0, chunk_costs=None):
        """Replay the §4.2 clock charges for the stage's inner steps and land
        the whole stage in the trace with one Trace.extend call.
        ``eval_charge`` > 0 bills one eval pass of that many points after
        each chunk — the variance probe (charged like DSM's norm test).
        ``chunk_costs`` (parallel to ``rec.chunk_lengths()``) carries each
        chunk's examples-per-step when it ran on a sweep segment instead of
        the whole window; ``None`` entries charge the full ``n_t``."""
        self._collect_host_records(ctx, info)
        clock, cost, trace = ctx["clock"], ctx["cost"], ctx["trace"]
        fs, ffull = rec.f_window(), rec.f_full()
        n = len(fs)
        times = np.empty(n)
        accs = np.empty(n, dtype=np.int64)
        touched = 0
        i = 0
        for ci, clen in enumerate(rec.chunk_lengths()):
            chunk_n = info.n_t
            if chunk_costs and ci < len(chunk_costs) \
                    and chunk_costs[ci] is not None:
                chunk_n = int(chunk_costs[ci])
            for j in range(clen):
                clock.batch_update(cost(chunk_n))
                touched += cost(chunk_n)
                if eval_charge and j == clen - 1:
                    clock.eval_pass(min(eval_charge, chunk_n))
                    touched += min(eval_charge, chunk_n)
                times[i], accs[i] = clock.time, clock.data_accesses
                i += 1
        self._note_access(ctx, touched)
        every = max(1, int(policy.record_every))
        idx = [i for i in range(n) if i % every == 0 or i == n - 1]
        extras = None
        if ctx["probe"] is not None:
            extras = [{"probe": float(ctx["probe"](rec.param_at(i)))}
                      for i in idx]
        new = trace.extend(
            step=[ctx["step_count"] + i for i in idx], stage=info.stage,
            window=info.n_t, time=times[idx], accesses=accs[idx],
            f_window=fs[idx], f_full=ffull[idx], extra=extras)
        ctx["step_count"] += n
        ctx["stages"] += 1
        self._emit_stage_totals(ctx, info, steps=n, touched=touched)
        if ctx["progress"]:
            for p in new:
                ctx["progress"](p)

    @staticmethod
    def _emit_stage_totals(ctx, info: StageInfo, *, steps: int,
                           touched: int) -> None:
        """One ``stage.totals`` counter per stage: the cumulative clock and
        engine state the RunReport differences into per-stage rows."""
        if ctx["obs"] is None:
            return
        clock = ctx["clock"]
        ctx["obs"].counter(
            "stage.totals", tags={"stage": info.stage}, window=info.n_t,
            steps=steps, touched=touched, time=clock.time,
            accesses=clock.data_accesses, loaded=clock.points_loaded,
            transfers=ctx["transfers"], stages=ctx["stages"])

    # ------------------------------------------------------- two-track stages
    def _race(self, ctx, optimizer, objective, policy, w, st_slow, st_fast,
              win_t, win_prev, full_data):
        """One race round: both tracks step from ``w`` until condition (3)
        fires or ``max_stage_iters`` elapse, on the device, with one pull
        (module docstring).  Returns the slow track's carries at the
        trigger and the round's pulled histories, cut at the trigger."""
        M = int(policy.max_stage_iters)
        wins = (win_t, win_prev, full_data)
        start = [w, st_slow, w, st_fast]
        del w, st_slow, st_fast
        key = (id(optimizer), id(objective), id(policy), policy.condition,
               M, ctx["probe"] is not None,
               _signature(start, addresses=False),
               _signature(wins, addresses=True))
        graph = ctx["race_graph"]
        if graph is not None and graph.key != key:
            self._drop_race_graph(ctx)
            graph = None
        if graph is not None:           # replay it from step 1
            bufs = graph.bufs
            for dst, src in zip(graph.scalars, _window_scalars(wins)):
                dst.copy_(src)
            bufs["s"].zero_()
            bufs["triggered"].zero_()
            loop = graph.loop
            ops.rerun_race_loop(loop, start)
            carry = loop.carry
            ctx["capture_s"].append(0.0)
        else:
            dev = tree_leaves(start[0])[0].device
            bufs = {"hist": torch.zeros((3, M), dtype=torch.float32,
                                        device=dev),
                    "s": torch.zeros((), dtype=torch.int64, device=dev),
                    "triggered": torch.zeros((), dtype=torch.bool,
                                             device=dev)}
            if ctx["probe"] is not None:
                bufs["W"] = _param_buffer(start[0], M)
            scalars: list = []
            staged = _stage_scalars(wins, scalars)
            _, race_step = race_step_fns(optimizer, objective, policy,
                                         *staged, bufs["hist"], bufs["s"],
                                         bufs.get("W"))
            # what the race starts from, which a step's output may view and
            # the WHILE graph must not write
            keep = [x for x in tree_leaves([start, wins])
                    if isinstance(x, torch.Tensor)]
            carry = race_step(start)
            del start
            bufs["s"] += 1
            loop = None
            if M > 1:
                loop = ops.race_loop(race_step, carry, bufs["hist"],
                                     bufs["s"], bufs["triggered"], M, keep)
                carry = loop.carry
                ctx["capture_s"].append(loop.capture_s)
                if loop.replayable:
                    ctx["race_graph"] = _RaceGraph(
                        key, loop, bufs, scalars,
                        held=(optimizer, objective, policy, wins))
        pulled = _pull(ctx, bufs)
        n = int(pulled["s"])
        if loop is not None:
            ops.finish_race_loop(loop, n, close=ctx["race_graph"] is None)
        out = {"hist": pulled["hist"][:, :n],
               "triggered": bool(pulled["triggered"])}
        if "W" in pulled:
            out["W"] = tree_map(lambda b: b[:n], pulled["W"])
        return carry[0], carry[1], out

    @staticmethod
    def _drop_race_graph(ctx) -> None:
        """Free the kept race graph, if any."""
        graph, ctx["race_graph"] = ctx["race_graph"], None
        if graph is not None:
            graph.loop.close()

    def _flush_race_stage(self, ctx, policy, info: StageInfo,
                          rec: StageRecords, probe_k: int) -> None:
        """A racing stage's flush: replay the clock charges and land the
        stage in the trace with one Trace.extend call."""
        clock, cost, trace = ctx["clock"], ctx["cost"], ctx["trace"]
        n_prev, n_t = info.n_prev, info.n_t
        s = rec.steps
        self._collect_host_records(ctx, info)
        # replay the per-step clock charges: slow update, fast update,
        # condition evaluation (charged per the paper unless disabled),
        # plus one variance-probe eval at each race round's end
        times = np.empty(s)
        accs = np.empty(s, dtype=np.int64)
        touched = 0
        i = 0
        for clen in rec.chunk_lengths():
            for j in range(clen):
                clock.batch_update(cost(n_t))
                clock.batch_update(cost(n_prev))
                touched += cost(n_t) + cost(n_prev)
                if policy.charge_condition_eval:
                    clock.eval_pass(cost(n_t))
                    touched += cost(n_t)
                if probe_k and j == clen - 1:
                    clock.eval_pass(probe_k)
                    touched += probe_k
                times[i], accs[i] = clock.time, clock.data_accesses
                i += 1
        self._note_access(ctx, touched)
        extras = [{"f_fast_on_t": float(rec.f_fast_on_t[i])}
                  for i in range(s)]
        if ctx["probe"] is not None:
            for i in range(s):
                extras[i]["probe"] = float(ctx["probe"](rec.param_at(i)))
        new = trace.extend(
            step=np.arange(ctx["step_count"], ctx["step_count"] + s),
            stage=info.stage, window=n_t, time=times, accesses=accs,
            f_window=rec.f_window(), f_full=rec.f_full(), extra=extras)
        ctx["step_count"] += s
        ctx["stages"] += 1
        self._emit_stage_totals(ctx, info, steps=s, touched=touched)
        if ctx["progress"]:
            for p in new:
                ctx["progress"](p)

    def _run_two_track(self, ctx, dataset, optimizer, objective,
                       policy: TwoTrack, carry: list, full_data, *,
                       first_stage: int = 0):
        """The racing stages, then the final phase, from ``carry`` ([w,
        state], updated in place); stages before ``first_stage`` ran before
        a checkpoint and are skipped."""
        w, state = carry
        carry.clear()
        *racing, final_info = self.stage_infos(policy, dataset.n)
        try:
            w, state = self._race_stages(ctx, dataset, optimizer, objective,
                                         policy, w, state, racing,
                                         full_data, first_stage)
        finally:
            self._drop_race_graph(ctx)

        # final phase: full window until the step budget is spent
        if first_stage > final_info.stage:
            carry[:] = (w, state)       # the checkpoint is past the final phase
            return
        carry[:] = (w, optimizer.reset_memory(
            state if self.carry_state else optimizer.init(w)))
        del w, state
        self._run_scan_stage(ctx, dataset, optimizer, objective, policy,
                             final_info, carry, full_data,
                             eval_full=policy.final_eval_full)

    def _race_stages(self, ctx, dataset, optimizer, objective, policy, w,
                     state, racing, full_data, first_stage: int):
        """The racing stages from (``w``, ``state``); returns the carries
        the final phase starts from."""
        clock, obs = ctx["clock"], ctx["obs"]
        for info in racing:
            if info.stage < first_stage:
                continue                # completed before the checkpoint
            n_prev, n_t = info.n_prev, info.n_t
            if obs is not None:
                obs.set_context(stage=info.stage)
                obs.instant("stage.begin", window=n_t, n_next=info.n_next,
                            final=info.is_final)
            with _obs_span(obs, "stage.acquire", window=n_t):
                win_t = self._acquire_window(dataset, n_t, info.n_next)
                win_prev = dataset.window(n_prev)  # resident prefix: no loads
            if self.wait_on_expand:
                clock.wait_for(n_t)
            st_slow = optimizer.reset_memory(
                state if self.carry_state else optimizer.init(w))
            st_fast = optimizer.init(w)
            policy.stage_begin(info)
            probe_k = min(int(policy.probe), n_t) \
                if policy.wants_variance else 0
            rec = StageRecords()
            fast_hist: list[np.ndarray] = []
            # race rounds: plain TwoTrack always confirms after one round;
            # a ComposedPolicy veto can hold the stage open, re-racing from
            # the current point with a fresh fast track
            while True:
                if self.profiler is not None and rec.steps == 0:
                    race_tracks, _ = race_step_fns(
                        optimizer, objective, policy, win_t, win_prev,
                        full_data, None, None)
                    self.profiler.observe(info, race_tracks, (
                        [w, st_slow, w, st_fast], win_t, win_prev,
                        full_data), {})
                with _obs_span(obs, "stage.compute", window=n_t):
                    w, state, pulled = self._race(
                        ctx, optimizer, objective, policy, w, st_slow,
                        st_fast, win_t, win_prev, full_data)
                f_slow, f_fast, f_full = pulled["hist"]
                rec.add_chunk(f_slow, f_full, pulled.get("W"))
                fast_hist.append(f_fast)
                rec.f_fast_on_t = np.concatenate(fast_hist)
                rec.triggered = pulled["triggered"]
                if probe_k:             # the variance test: one more pull
                    v, g2 = variance_stats(objective, w, win_t, probe_k)
                    stats = _pull(ctx, {"var": v, "g2": g2})
                    rec.var, rec.g2 = float(stats["var"]), float(stats["g2"])
                expand = policy.should_expand(info, rec)
                if obs is not None:
                    fs = rec.f_fast_on_t
                    obs.instant("expand.decision", expand=bool(expand),
                                window=n_t, steps=rec.steps, var=rec.var,
                                g2=rec.g2, triggered=rec.triggered,
                                f_last=float(fs[-1]) if len(fs) else None)
                if expand:
                    break
                if rec.steps > self.max_engine_steps:
                    raise RuntimeError(
                        f"policy {policy.name} never expanded after "
                        f"{rec.steps} racing steps")
                st_slow = state
                st_fast = optimizer.init(w)
            del st_slow, st_fast
            if ctx["race_graph"] is not None:
                # the next round writes the graph's carries: hand on copies
                w, state = tree_map(torch.clone, (w, state))
            with _obs_span(obs, "stage.flush", window=n_t):
                self._flush_race_stage(ctx, policy, info, rec, probe_k)
            policy.stage_end(info, rec)
            self._stage_boundary(ctx, info, w, state)
            if obs is not None:
                obs.instant("stage.end", window=n_t)
                obs.clear_context("stage")
        return w, state
