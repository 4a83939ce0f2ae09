"""ServeTrainLoop — the closed loop: traffic → serve → log → ingest →
expand → swap; the port of ``repro.serve.loop``.

A ``BetServer`` answers synthetic traffic through the seed decode path;
every served request (prompt + generated continuation) is logged, in
arrival order, into an ``OnlineShardStore`` — the corpus *is* the request
log, and BET's nested prefix windows make that legal (expansion is
append, never reshuffle).  A ``TrafficDriven`` policy expands the training
window as requests land, holding stages open (and pumping more traffic)
while arrivals lag the schedule; every stage boundary publishes an atomic
checkpoint that the server hot-swaps without dropping an in-flight
request.

The loop is described by an ordinary :class:`~repro_torch.api.RunSpec`
with ``serve.enabled=True`` — ``build_loop(spec, device=...)`` is the
front door (``repro_torch.api.build`` refuses serve specs and points
here).  The training stack is composed from the same pieces a Session
uses: StreamingDataset (masked plane), the workload family adapter's
step/objective factories (kernel-routed for mamba and rglru), build_policy,
StageCheckpointer, BetEngine — only the corpus and the stage loop differ
(``BetEngine.run_online``).  Everything runs on ``device`` (the card
unless the caller asks for the CPU); each tick pulls its generated tokens
to the host once, to log them.

The reference's ``ObsSpec.health`` detectors come with the observability
slice and are refused here.
"""
from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

from ..api.registry import LM_OPTIMIZER, build_policy
from ..api.session import lm_config
from ..api.specs import RunSpec, SpecError
from ..core.engine import BETSchedule, BetEngine
from ..core.timemodel import SimulatedClock
from ..data.plane import StreamingDataset
from ..device import resolve_device
from ..elastic import StageCheckpointer
from ..obs import EventRecorder, RunReport
from ..obs.metrics import attach_clock, attach_dataset, attach_server
from .ingest import OnlineShardStore
from .policy import TrafficDriven
from .swap import BetServer, CheckpointWatcher


class TrafficGenerator:
    """Deterministic synthetic traffic: Zipf-distributed prompts (the same
    family as data/window.synth_corpus, so the logged corpus looks like the
    offline LM workload)."""

    def __init__(self, vocab: int, prompt_len: int, batch: int, *,
                 seed: int = 0, alpha: float = 1.2):
        self.vocab = max(2, int(vocab))
        self.prompt_len = int(prompt_len)
        self.batch = int(batch)
        self.rng = np.random.default_rng(seed)
        self.alpha = float(alpha)

    def next(self) -> np.ndarray:
        z = self.rng.zipf(self.alpha, size=(self.batch, self.prompt_len))
        return ((z - 1) % self.vocab).astype(np.int32)


def _traffic_members(policy) -> list[TrafficDriven]:
    """Every TrafficDriven member of a (possibly composed) policy tree."""
    members = [policy, getattr(policy, "primary", None)]
    members += list(getattr(policy, "vetoes", ()))
    members += list(getattr(policy, "any_of", ()))
    return [p for p in members if isinstance(p, TrafficDriven)]


def _attach_traffic(policy, source, pump) -> list[TrafficDriven]:
    """Wire the live store/pump into every TrafficDriven member of a
    (possibly composed) policy tree; returns the wired members."""
    wired = _traffic_members(policy)
    for p in wired:
        p.attach(source, pump)
    return wired


def _validate_serve(spec: RunSpec) -> tuple[int, int]:
    s, d = spec.serve, spec.data
    if not s.enabled:
        raise SpecError("build_loop needs ServeSpec.enabled=True")
    if d.kind != "lm" or spec.model is None:
        raise SpecError("the serve loop decodes an LM: DataSpec.kind='lm' "
                        "plus a ModelSpec are required")
    if d.plane != "plane":
        raise SpecError("the serve loop ingests through the streaming "
                        "plane: DataSpec.plane='plane'")
    if spec.optimizer.name != LM_OPTIMIZER:
        raise SpecError(f"the serve loop trains through {LM_OPTIMIZER!r}, "
                        f"got {spec.optimizer.name!r}")
    if spec.topology.hosts != 1:
        raise SpecError("the serve loop is single-host (the multi-host "
                        "runtime serves offline corpora)")
    if not spec.checkpoint.directory:
        raise SpecError("the serve loop publishes stage checkpoints for "
                        "the hot-swap server: CheckpointSpec.directory is "
                        "required")
    if spec.obs.health:
        raise SpecError(
            "ObsSpec.health (the serve loop's live detectors) is not yet "
            "ported to repro_torch; it comes with the observability slice "
            "(ROADMAP queue A11)")
    if s.requests_per_tick < 1 or s.prompt_len < 1:
        raise SpecError("requests_per_tick and prompt_len must be >= 1")
    gen = s.gen_tokens or (d.seq_len + 1 - s.prompt_len)
    if gen < 1:
        raise SpecError(f"prompt_len={s.prompt_len} leaves no room to "
                        f"generate in a {d.seq_len + 1}-token training row")
    if s.prompt_len + gen != d.seq_len + 1:
        raise SpecError(
            f"logged rows must tile training rows exactly: prompt_len + "
            f"gen_tokens must equal seq_len + 1 "
            f"({s.prompt_len} + {gen} != {d.seq_len + 1})")
    capacity = s.capacity or d.corpus_size
    if capacity < spec.schedule.n0:
        raise SpecError(f"capacity={capacity} below n0={spec.schedule.n0}: "
                        f"the first stage could never fill")
    return gen, capacity


class ServeTrainLoop:
    """One serve-while-you-train run: own the server, the request log, and
    the BET training stack; ``run()`` drives them to completion.
    ``params0`` gives the weights to serve and train from (default: the
    family's initialization from ``data.seed``)."""

    def __init__(self, spec: RunSpec, *, device="cuda",
                 max_ticks: int | None = None, params0=None):
        self.gen_tokens, self.capacity = _validate_serve(spec)
        self.spec = spec
        self.device = resolve_device(device)
        d, m, s = spec.data, spec.model, spec.serve
        cfg = lm_config(m)
        if cfg.input_mode != "tokens":
            raise SpecError(f"{m.arch} is not a token-mode arch; the serve "
                            f"loop decodes tokens")
        self.cfg = cfg
        # the family adapter supplies params + train step + objective —
        # the serve loop trains exactly what an offline session would
        # (kernel-routed for mamba/rglru); imported here: the workloads
        # package imports repro_torch.api
        from ..workloads.families import resolve_family
        self.family = resolve_family(m, cfg)
        self.params0 = params0 if params0 is not None else \
            self.family.build_params(cfg, d.seed, device=self.device)
        self.store = OnlineShardStore(
            (d.seq_len + 1,), np.int32, shard_size=d.shard_size,
            capacity=self.capacity)
        self.server = BetServer(cfg, self.params0,
                                cache_len=d.seq_len + 1, stage=-1)
        self.watcher = CheckpointWatcher(
            spec.checkpoint.directory, self.params0, self.server) \
            if s.swap else None
        self.traffic = TrafficGenerator(
            cfg.vocab_size, s.prompt_len, s.requests_per_tick, seed=s.seed)
        # tick budget: enough traffic to fill the log twice over — a
        # backstop that closes the source rather than hanging a held stage
        self.max_ticks = max_ticks if max_ticks is not None else \
            2 * (self.capacity // s.requests_per_tick + 1)
        self.ticks = 0
        # sampled decoding draws from this generator (the reference splits
        # a key seeded with seed + 1)
        self.generator = torch.Generator(device=self.device).manual_seed(
            s.seed + 1)
        self.staleness_warm: list[int] = []
        self.serve_wall_s = 0.0     # generate + log + swap-poll, per tick
        self.trace = None
        # the serve loop always records: serving and training feed the same
        # telemetry stream, so report() is a RunReport like any offline run
        self.recorder = EventRecorder()
        attach_server(self.server, self.recorder)
        self.run_report: RunReport | None = None

    # ------------------------------------------------------------- serving
    def tick(self) -> bool:
        """One serving tick: answer a prompt batch, log it, poll for fresh
        weights.  Returns False once the log is closed (no more traffic)."""
        if self.store.closed:
            return False
        if self.ticks >= self.max_ticks or \
                self.store.total_logged + self.traffic.batch > self.capacity:
            self.store.close()
            if self.watcher is not None:
                self.watcher.poll()
            return False
        self.ticks += 1
        t0 = time.perf_counter()
        with self.recorder.span("serve.tick", tick=self.ticks):
            prompts = self.traffic.next()
            out = self.server.generate(
                torch.from_numpy(prompts).to(self.device),
                gen_tokens=self.gen_tokens, greedy=self.spec.serve.greedy,
                generator=self.generator)
            # the tick's one device-to-host pull: the tokens it logs
            self.store.append(
                np.concatenate([prompts, out.cpu().numpy()], axis=1))
            self.recorder.instant(
                "serve.ingest", examples=int(prompts.shape[0]),
                sealed=self.store.num_examples,
                total=self.store.total_logged)
            if self.watcher is not None:
                # sampled before the poll: the weights this tick's request
                # was actually served under, vs the newest published
                # checkpoint
                if self.server.swap_count > 0:
                    stale = self.watcher.staleness()
                    self.staleness_warm.append(stale)
                    self.recorder.instant("serve.staleness", staleness=stale)
                self.watcher.poll()
        self.serve_wall_s += time.perf_counter() - t0
        return True

    # ------------------------------------------------------------ training
    def run(self) -> dict:
        """Seed the log, train-while-serving, drain, report."""
        spec, d = self.spec, self.spec.data
        n0 = spec.schedule.n0
        eval_rows = min(d.eval_rows, n0)
        # seed phase: enough sealed traffic for the first window + probe
        while self.store.num_examples < max(n0, eval_rows):
            if not self.tick():
                break
        if self.store.num_examples < 1:
            raise SpecError("the log closed before any shard sealed: raise "
                            "capacity or lower shard_size")
        eval_tokens = torch.from_numpy(self.store.prefix(
            min(eval_rows, self.store.num_examples))).to(self.device)
        dataset = StreamingDataset([self.store], masked=True,
                                   growth=spec.schedule.growth,
                                   prefetch_workers=d.prefetch_workers,
                                   device=self.device)
        lr = float(spec.optimizer.params.get("lr", 1e-3))
        batch_size = int(spec.optimizer.params.get("batch_size", 8))
        optimizer = self.family.step(self.cfg, lr=lr,
                                     batch_size=batch_size)
        objective = self.family.objective(self.cfg,
                                          int(eval_tokens.shape[0]))
        policy = build_policy(spec.policy)
        wired = _attach_traffic(policy, self.store, self.tick)
        if not wired:
            dataset.close()
            raise SpecError(
                f"the serve loop needs a traffic_driven policy somewhere "
                f"in the composition (got {policy.name!r}): nothing else "
                f"pumps traffic while a stage holds")
        checkpointer = StageCheckpointer(
            spec.checkpoint.directory, keep=spec.checkpoint.keep,
            every=spec.checkpoint.every, spec=spec.to_dict())
        engine = BetEngine(
            schedule=BETSchedule(n0=min(n0, self.store.num_examples),
                                 growth=spec.schedule.growth),
            step_cost=(lambda n_t: batch_size)
            if spec.schedule.step_cost == "batch" else None,
            carry_state=spec.schedule.carry_state)
        engine.stage_callback = checkpointer
        clock = SimulatedClock(**spec.schedule.clock)
        # one stream for both halves of the closed loop: the engine's stage
        # spans land between the serving ticks that fed them
        engine.recorder = self.recorder
        attach_dataset(dataset, self.recorder)
        attach_clock(clock, self.recorder)
        checkpointer.recorder = self.recorder
        for p in wired:
            p.recorder = self.recorder
        self.recorder.instant("run.meta", fields={
            "name": spec.name, "n": 0,      # open corpus: n unknown up front
            "hosts": 1, "policy": spec.policy.name,
            "n0": spec.schedule.n0, "growth": spec.schedule.growth,
            "row_bytes": int(self.store.example_nbytes)})
        try:
            self.trace = engine.run_online(
                dataset, optimizer, objective, policy,
                source=self.store, w0=self.params0, clock=clock,
                eval_data=eval_tokens,
                trace_name=None if spec.name == "run" else spec.name,
                meta={"arch": self.cfg.name, "serve": True})
        finally:
            self.store.close()
            dataset.close()
        self.final_clock = clock.snapshot()
        # drain: adopt the final published checkpoint (staleness -> 0).
        # No traffic flows here, so these polls add no warm staleness
        # samples — those measure the weights *served requests* saw
        while self.watcher is not None and self.watcher.staleness() > 0:
            if not self.watcher.poll():
                break
        return self.report(dataset, policy, checkpointer, clock)

    # ------------------------------------------------------------- results
    def report(self, dataset, policy, checkpointer, clock) -> dict:
        meter = dataset.meter.snapshot()
        holds = sum(p.holds_total for p in _traffic_members(policy))
        # the same per-stage summary an offline Session prints: both sides
        # of the loop fold out of the one event stream
        rr = RunReport.from_recorder(self.recorder)
        self.run_report = rr
        rep = {
            "ticks": self.ticks,
            "requests": self.server.requests_completed,
            "logged_examples": self.store.num_examples,
            "capacity": self.capacity,
            "serve_wall_s": round(self.serve_wall_s, 4),
            "tokens_per_s_wall": round(
                self.server.tokens_generated / max(self.serve_wall_s, 1e-9),
                2),
            "stages": self.trace.meta.get("stages") if self.trace else None,
            "holds": holds,
            "server": self.server.metrics(),
            "data_plane": meter,
            "clock": clock.snapshot(),
            "checkpoints": list(checkpointer.saved),
            "stage_table": rr.stage_rows(),
            "serve_events": rr.serve_summary(),
        }
        obs = self.spec.obs
        if obs.enabled and obs.dir:
            d = pathlib.Path(obs.dir)
            d.mkdir(parents=True, exist_ok=True)
            self.recorder.to_jsonl(d / "events.jsonl")
            if obs.chrome_trace:
                self.recorder.to_chrome_trace(d / "trace.json")
            if obs.report:
                rr.save(d)
            rep["obs_dir"] = str(d)
        if self.watcher is not None:
            rep["staleness"] = {
                "samples": self.watcher.staleness_samples,
                "warm_samples": self.staleness_warm,
                "max_warm": max(self.staleness_warm, default=0),
                "final": self.watcher.staleness(),
                "published_stage": self.watcher.published_stage(),
                "adopted_stage": self.server.adopted_stage,
            }
        return rep


def build_loop(spec: RunSpec | dict, *, device="cuda",
               **kw) -> ServeTrainLoop:
    """The serve-while-you-train front door: RunSpec -> ServeTrainLoop on
    ``device``."""
    if isinstance(spec, dict):
        spec = RunSpec.from_dict(spec)
    return ServeTrainLoop(spec, device=device, **kw)
