"""Unified Batch-Expansion Training engine — the port of
``repro.core.engine``.

The *when-to-expand* decision is orthogonal to the *how-to-step* loop:

  * ``ExpansionPolicy`` — ``stage_begin`` / ``plan_steps`` /
    ``should_expand`` / ``stage_end``.  Ported policies:

      - ``FixedSteps``        Algorithm 1/3: κ̂ inner iterations per stage,
      - ``TwoTrack``          Algorithm 2: the parameter-free condition (3),
      - ``NeverExpand``       the Batch baseline (one full-window stage),
      - ``ComposedPolicy``    veto (AND) / any_of (OR) composition.

  * ``BetEngine.run(dataset, optimizer, objective, policy, ...)`` — the
    one driver.

Stages run on the device.  A scan stage's chunk is a Python loop of
optimizer steps (each free of host syncs) that writes f̂_t(w) and f̂(w)
into preallocated device tensors; the host pulls them with one transfer
per chunk (``trace.meta["host_transfers"]`` counts the pulls), then replays
the §4.2 clock charges.

The Two-Track race runs in chunks whose cumulative sizes are 2, 4, 8, …:
both tracks step through a chunk with no host read, and one pull brings
the chunk's histories to the host, which finds the first step that meets
condition (3).  Inside a chunk the slow track freezes on the device once
condition (3) holds: a device bool ``frozen`` is raised from the
histories the step has just written, and every later step of the chunk
keeps the slow carry's old leaves where it is raised
(``torch.where(frozen, old, new)``, leaf by leaf).  So when the host finds
the trigger, the live slow carry is already the trigger step's, and
nothing is rolled back; the select needs one leaf of temporaries, never a
second carry, so a carry of any size races in chunks.  Host-side leaves
(a Python step counter) cannot be selected on the device: the host keeps
their values per step and restores the trigger step's.  A racing stage of
s steps costs about ⌈log₂ s⌉ transfers.  The steps run past a trigger are
counted in ``trace.meta["race_overshoot"]``; they never reach the trace
or the clock.

Parameters and optimizer states may be single tensors (the convex path) or
nested dicts of tensors (the LM path); optimizers are functional (a step
returns new tensors), so both tracks can start from one ``w``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..optim.api import BatchOptimizer, Objective, tree_leaves, tree_map
from .timemodel import SimulatedClock
from .trace import Trace


# The race's chunks double (cumulative sizes 2, 4, 8, …).  False runs
# chunks of one step after the first two, reading condition (3) once per
# step with no freeze: the tests hold the doubling race to it.
RACE_DOUBLING = True


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


# --------------------------------------------------------------------- hooks
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

    def add_chunk(self, f_window, f_full=None, params=None):
        self._f_window.append(np.asarray(f_window))
        if f_full is not None:
            self._f_full.append(np.asarray(f_full))
        if params is not None:
            self._params.append(params)

    @property
    def steps(self) -> int:
        return sum(len(c) for c in self._f_window)

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
    record_every = 1

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


def _host(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: such leaves come back widened to float32
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _pull(ctx, tensors: dict) -> dict:
    """One device-to-host transfer of a chunk's records (the reference's
    one ``jax.device_get`` of a dict), counted in ``host_transfers``."""
    ctx["transfers"] += 1
    return tree_map(_host, tensors)


def _param_buffer(w, k: int):
    """Device buffers for ``k`` steps of parameters shaped like ``w``."""
    return tree_map(lambda x: torch.empty((k,) + tuple(x.shape),
                                          dtype=x.dtype, device=x.device), w)


def _store(buf, s: int, w) -> None:
    """Write step ``s``'s parameters into the buffers of ``_param_buffer``."""
    def put(b, x):
        b[s] = x
    tree_map(put, buf, w)


def _hold(frozen: torch.Tensor, old, new):
    """``new`` with each tensor leaf kept at ``old``'s value where the
    device bool ``frozen`` is raised.  ``new``'s dicts (fresh from an
    optimizer step) are overwritten in place, leaf by leaf, so each
    unkept leaf is freed as soon as its select is made: one leaf of
    temporaries, never a second tree.  Host-side leaves keep ``new``'s
    value (the race restores them from its host record)."""
    if isinstance(new, dict):
        for k in new:
            new[k] = _hold(frozen, old[k], new[k])
        return new
    return tree_map(lambda o, n: torch.where(frozen, o, n)
                    if isinstance(n, torch.Tensor) else n, old, new)


def _host_part(tree):
    """The host-side leaves of ``tree``, tensors blanked to None."""
    return tree_map(lambda x: None if isinstance(x, torch.Tensor) else x,
                    tree)


def _with_host_part(tree, part):
    return tree_map(lambda x, h: x if isinstance(x, torch.Tensor) else h,
                    tree, part)


def _first_trigger(f_slow: np.ndarray, f_fast: np.ndarray, lo: int,
                   hi: int) -> int | None:
    """The first s in [lo, hi], s >= 2, at which condition (3) holds:
    the slow track after ⌊s/2⌋ steps already beats the fast track after s
    (``f_*[i]`` is the value after step i + 1)."""
    for s in range(max(lo, 2), hi + 1):
        if f_slow[max(0, s // 2 - 1)] < f_fast[s - 1]:
            return s
    return None


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
    of re-initializing."""
    schedule: BETSchedule = dataclasses.field(default_factory=BETSchedule)
    step_cost: Callable[[int], int] | None = None
    wait_on_expand: bool = False
    carry_state: bool = False
    max_engine_steps: int = 100_000     # runaway-policy backstop
    # once-per-stage boundary callback (StageEnd)
    stage_callback: Callable | None = None

    def run(self, dataset, optimizer: BatchOptimizer, objective: Objective,
            policy: ExpansionPolicy, *, w0=None, clock: SimulatedClock | None = None,
            eval_data=None, probe: Callable | None = None,
            trace_name: str | None = None, meta: dict | None = None,
            progress: Callable | None = None, opt_state0=None) -> Trace:
        clock = clock or SimulatedClock()
        N = dataset.n
        full_data = eval_data if eval_data is not None else dataset.window(N)
        w = w0 if w0 is not None else torch.zeros(
            (dataset.d,), dtype=torch.float32, device=full_data[0].device)
        state = optimizer.init(w) if opt_state0 is None else dict(opt_state0)
        trace = Trace(trace_name or policy.name,
                      meta={"engine": "BetEngine", "policy": policy.name,
                            "optimizer": optimizer.name, **(meta or {})})
        cost = self.step_cost or (lambda n: n)
        ctx = {"trace": trace, "clock": clock, "cost": cost,
               "probe": probe, "progress": progress, "dataset": dataset,
               "step_count": 0, "transfers": 0, "stages": 0, "overshoot": 0}

        # the live carry: only this list holds it, so each step's output
        # replaces its input and no earlier carry stays referenced
        carry = [w, state]
        del w, state
        if policy.kind == "two_track":
            self._run_two_track(ctx, dataset, optimizer, objective, policy,
                                carry, full_data)
        else:
            for info in self.stage_infos(policy, N):
                carry[1] = optimizer.reset_memory(carry[1])  # f̂_t changed
                self._run_scan_stage(ctx, dataset, optimizer, objective,
                                     policy, info, carry, full_data)
        trace.params = carry[0]
        trace.meta["host_transfers"] = ctx["transfers"]
        trace.meta["race_overshoot"] = ctx["overshoot"]
        trace.meta["stages"] = ctx["stages"]
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

    # ------------------------------------------------------------ scan stages
    def _run_chunk(self, ctx, optimizer, objective, carry: list, win,
                   full_data, k: int, *, eval_full: bool):
        """``k`` inner steps on ``win`` from ``carry`` ([w, state], updated
        in place); per-step records land in device buffers and come back
        in one pull."""
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
        return _pull(ctx, bufs)

    def _run_scan_stage(self, ctx, dataset, optimizer, objective, policy,
                        info: StageInfo, carry: list, full_data, *,
                        eval_full=None):
        """One stage from ``carry`` ([w, state], updated in place)."""
        eval_full = policy.eval_full if eval_full is None else eval_full
        win = dataset.window(info.n_t)
        if self.wait_on_expand:
            ctx["clock"].wait_for(info.n_t)
        policy.stage_begin(info)
        rec = StageRecords()
        while True:
            k = int(policy.plan_steps(info, rec.steps))
            pulled = self._run_chunk(ctx, optimizer, objective, carry, win,
                                     full_data, k, eval_full=eval_full)
            rec.add_chunk(pulled["f"], pulled.get("f_full"), pulled.get("w"))
            if policy.should_expand(info, rec):
                break
            if rec.steps > self.max_engine_steps:
                raise RuntimeError(
                    f"policy {policy.name} never expanded after {rec.steps} steps")
        self._flush_stage(ctx, policy, info, rec)
        policy.stage_end(info, rec)
        self._stage_boundary(ctx, info, *carry)

    def _stage_boundary(self, ctx, info: StageInfo, w, state) -> None:
        """Once-per-stage boundary: the stage's records are flushed, the
        trace is current, and (w, state) are the exact carries the next
        stage starts from."""
        if self.stage_callback is not None:
            self.stage_callback(StageEnd(
                info=info, params=w, opt_state=state, clock=ctx["clock"],
                dataset=ctx["dataset"], trace=ctx["trace"],
                step_count=ctx["step_count"], stages=ctx["stages"],
                transfers=ctx["transfers"], overshoot=ctx["overshoot"]))

    def _flush_stage(self, ctx, policy, info: StageInfo, rec: StageRecords):
        """Replay the §4.2 clock charges for the stage's inner steps and land
        the whole stage in the trace with one Trace.extend call."""
        clock, cost, trace = ctx["clock"], ctx["cost"], ctx["trace"]
        fs, ffull = rec.f_window(), rec.f_full()
        n = len(fs)
        times = np.empty(n)
        accs = np.empty(n, dtype=np.int64)
        for i in range(n):
            clock.batch_update(cost(info.n_t))
            times[i], accs[i] = clock.time, clock.data_accesses
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
        if ctx["progress"]:
            for p in new:
                ctx["progress"](p)

    # ------------------------------------------------------- two-track stages
    def _race(self, ctx, optimizer, objective, policy, w, st_slow, st_fast,
              win_t, win_prev, full_data):
        """One race round: both tracks step from ``w`` until condition (3)
        fires or ``max_stage_iters`` elapse, in chunks with one pull each,
        the slow track frozen on the device from the trigger on (module
        docstring).  Returns the slow track's carries at the trigger and
        the round's pulled histories, cut at the trigger."""
        M = int(policy.max_stage_iters)
        dev = tree_leaves(w)[0].device
        hist = torch.empty((3, M), dtype=torch.float32, device=dev)
        W = _param_buffer(w, M) if ctx["probe"] is not None else None
        w_slow = w_fast = w
        host = np.empty((3, 0), dtype=np.float32)
        host_W = []
        s, trig = 0, None
        while trig is None and s < M:
            end = min(M, 2 if s < 2 else
                      1 << s.bit_length() if RACE_DOUBLING else s + 1)
            start, frozen, host_parts = s, None, {}
            while s < end:
                new_w, new_st, aux = optimizer.step(w_slow, st_slow,
                                                    objective, win_t)
                if frozen is not None:      # a trigger may have fired
                    new_w = _hold(frozen, w_slow, new_w)
                    new_st = _hold(frozen, st_slow, new_st)
                w_slow, st_slow = new_w, new_st
                del new_w, new_st
                w_fast, st_fast, _ = optimizer.step(w_fast, st_fast,
                                                    objective, win_prev)
                hist[0, s] = (objective(w_slow, win_t)
                              if policy.condition == "eval" else aux["f"])
                hist[1, s] = objective(w_fast, win_t)
                hist[2, s] = objective(w_slow, full_data)
                if W is not None:
                    _store(W, s, w_slow)
                s += 1
                if 2 <= s < end:            # condition (3) at step s
                    hit = hist[0, s // 2 - 1] < hist[1, s - 1]
                    frozen = hit if frozen is None else frozen | hit
                    host_parts[s] = _host_part(st_slow)
            tensors = {"hist": hist[:, start:end]}
            if W is not None:
                tensors["W"] = tree_map(lambda b: b[start:end], W)
            pulled = _pull(ctx, tensors)
            host = np.concatenate([host, pulled["hist"]], axis=1)
            if W is not None:
                host_W.append(pulled["W"])
            # condition (3), tested on the host over the chunk's steps
            trig = _first_trigger(host[0], host[1], start + 1, end)
            if trig is not None and trig < end:
                st_slow = _with_host_part(st_slow, host_parts[trig])
                ctx["overshoot"] += end - trig
                s = trig
        out = {"hist": host[:, :s], "triggered": trig is not None}
        if W is not None:
            out["W"] = tree_map(lambda *c: np.concatenate(c)[:s], *host_W)
        return w_slow, st_slow, out

    def _run_two_track(self, ctx, dataset, optimizer, objective,
                       policy: TwoTrack, carry: list, full_data):
        """The racing stages, then the final phase, from ``carry`` ([w,
        state], updated in place)."""
        clock, cost, trace = ctx["clock"], ctx["cost"], ctx["trace"]
        w, state = carry
        carry.clear()
        *racing, final_info = self.stage_infos(policy, dataset.n)
        for info in racing:
            n_prev, n_t = info.n_prev, info.n_t
            win_t = dataset.window(n_t)
            win_prev = dataset.window(n_prev)  # resident prefix: no loads
            if self.wait_on_expand:
                clock.wait_for(n_t)
            st_slow = optimizer.reset_memory(
                state if self.carry_state else optimizer.init(w))
            st_fast = optimizer.init(w)
            policy.stage_begin(info)
            rec = StageRecords()
            fast_hist: list[np.ndarray] = []
            # race rounds: plain TwoTrack always confirms after one round;
            # a ComposedPolicy veto can hold the stage open, re-racing from
            # the current point with a fresh fast track
            while True:
                w, state, pulled = self._race(
                    ctx, optimizer, objective, policy, w, st_slow, st_fast,
                    win_t, win_prev, full_data)
                f_slow, f_fast, f_full = pulled["hist"]
                rec.add_chunk(f_slow, f_full, pulled.get("W"))
                fast_hist.append(f_fast)
                rec.f_fast_on_t = np.concatenate(fast_hist)
                rec.triggered = pulled["triggered"]
                if policy.should_expand(info, rec):
                    break
                if rec.steps > self.max_engine_steps:
                    raise RuntimeError(
                        f"policy {policy.name} never expanded after "
                        f"{rec.steps} racing steps")
                st_slow = state
                st_fast = optimizer.init(w)
            s = rec.steps
            # replay the per-step clock charges: slow update, fast update,
            # condition evaluation (charged per the paper unless disabled)
            times = np.empty(s)
            accs = np.empty(s, dtype=np.int64)
            for i in range(s):
                clock.batch_update(cost(n_t))
                clock.batch_update(cost(n_prev))
                if policy.charge_condition_eval:
                    clock.eval_pass(cost(n_t))
                times[i], accs[i] = clock.time, clock.data_accesses
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
            if ctx["progress"]:
                for p in new:
                    ctx["progress"](p)
            policy.stage_end(info, rec)
            self._stage_boundary(ctx, info, w, state)

        # final phase: full window until the step budget is spent
        carry[:] = (w, optimizer.reset_memory(
            state if self.carry_state else optimizer.init(w)))
        del w, state
        self._run_scan_stage(ctx, dataset, optimizer, objective, policy,
                             final_info, carry, full_data,
                             eval_full=policy.final_eval_full)
