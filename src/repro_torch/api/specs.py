"""Declarative run specifications — the one front door to the BET stack.

The port's own copy of ``repro.api.specs`` (pure Python, no framework):
the JSON schema is identical, so a spec written by either package loads
in the other.  Docstrings below name the reference's components; the
port builds the ones it has (``repro_torch.api.build``) and refuses the
rest with a :class:`SpecError` that names the slice that brings them.

A :class:`RunSpec` is a plain, JSON-serializable description of an entire
Batch-Expansion Training run: the workload (:class:`DataSpec`), the
expansion policy (:class:`PolicySpec`, with veto/any combinators), the
inner optimizer (:class:`OptimizerSpec`), the §4.2 schedule + time model
(:class:`ScheduleSpec`), the host topology (:class:`TopologySpec`), the
elastic fault-tolerance surface (:class:`ElasticSpec`), checkpointing
(:class:`CheckpointSpec`) and — for the LM path — the model
(:class:`ModelSpec`).

Every component is addressable **by name** through the registries in
``repro.api.registry``, and every spec round-trips losslessly through
``to_dict``/``from_dict`` (and JSON), so a run is a reproducible artifact:
the spec is printed by ``--dry-run`` and saved into every stage
checkpoint.  ``repro.api.build(spec)`` composes the actual stack and
validates cross-component constraints *eagerly* (bad combinations fail at
build time with a :class:`SpecError`, never as a deep-stack failure
mid-run).
"""
from __future__ import annotations

import dataclasses
import json



class SpecError(ValueError):
    """A spec names unknown components or an invalid combination; raised
    eagerly at construction / ``build()`` time with an actionable message."""


def _plain(v):
    """Spec value -> JSON-safe plain data (dicts/lists/scalars)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    return v


class _Spec:
    """Shared serialization: ``to_dict``/``to_json`` walk the dataclass;
    ``from_dict`` rejects unknown keys with the valid field names (typos
    fail loudly, not silently as defaults)."""

    def to_dict(self) -> dict:
        return _plain(self)

    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict | None) -> "_Spec":
        d = dict(d or {})
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise SpecError(
                f"{cls.__name__} has no field(s) {unknown}; valid fields: "
                f"{sorted(names)}")
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "_Spec":
        return cls.from_dict(json.loads(text))

    def replace(self, **kw) -> "_Spec":
        return dataclasses.replace(self, **kw)


def _set(obj, **kw) -> None:
    for k, v in kw.items():
        object.__setattr__(obj, k, v)


def _coerce(obj, field: str, spec_cls) -> None:
    v = getattr(obj, field)
    if isinstance(v, dict):
        _set(obj, **{field: spec_cls.from_dict(v)})


# ------------------------------------------------------------------- tiering
@dataclasses.dataclass(frozen=True)
class TieringSpec(_Spec):
    """The tiered corpus plane (``repro.data.tiers``): an HBM byte budget
    for the hot window, a host-RAM byte budget for the shard ring
    (``0`` = unbounded: every example leaves disk exactly once per run),
    and the prefetcher's in-flight shard bound.  ``enabled`` requires the
    streaming plane (``DataSpec.plane="plane"``), a convex workload and a
    single host; ``manager`` names a :data:`repro.api.registry.TIERS`
    entry.  The budgets are *simulated* limits — the subsystem is fully
    exercisable on CPU."""
    enabled: bool = False
    hbm_bytes: int = 0              # device budget for the hot window
    host_bytes: int = 0             # ring budget; 0 = unbounded
    max_inflight: int | None = None  # Prefetcher backpressure bound
    manager: str = "ring"           # TIERS registry name


# ------------------------------------------------------------------ workload
@dataclasses.dataclass(frozen=True)
class DataSpec(_Spec):
    """The workload: what the data is and how it is served.

    ``kind="convex"`` is the paper's setting (a pre-permuted synthetic
    classification problem from ``repro.data.synthetic.PAPER_LIKE`` plus
    the Eq. 1 objective); ``kind="lm"`` is the beyond-paper token-corpus
    path.  ``plane`` picks the serving layer: ``"host"`` = host-slice
    prefix windows (the bit-exact reference), ``"plane"`` = the streaming
    data plane (shard store -> async prefetch -> device-resident window);
    multi-host topologies always stream."""
    kind: str = "convex"            # convex | lm
    # convex workload (synthetic.PAPER_LIKE generator + Eq. 1 objective)
    dataset: str = "w8a_like"
    scale: float = 1.0
    condition_boost: bool = False   # 10x the generator's eigen-spread
    # generator overrides merged into the PAPER_LIKE config (n / d /
    # condition / noise / sparsity) — stored as sorted (key, value) pairs
    # so the spec stays hashable; pass a plain dict
    generator: tuple = ()
    loss: str = "squared_hinge"     # squared_hinge | logistic
    lam: float = 1e-3
    # lm workload (synthetic Zipf token corpus)
    corpus_size: int = 1024
    seq_len: int = 128
    eval_rows: int = 64             # probe/eval-set rows (condition (3))
    # serving layer
    plane: str = "host"             # host | plane
    store: str = "memory"           # memory | memmap
    workdir: str | None = None      # memmap: shard directory
    shard_size: int = 64
    delay_ms: float = 0.0           # > 0: throttle reads (models a NAS)
    prefetch_workers: int = 1
    tiering: TieringSpec = dataclasses.field(default_factory=TieringSpec)
    seed: int = 0

    def __post_init__(self):
        items = self.generator.items() if isinstance(self.generator, dict) \
            else ((k, v) for k, v in self.generator)
        _set(self, generator=tuple(sorted((str(k), v) for k, v in items)))
        _coerce(self, "tiering", TieringSpec)


# ------------------------------------------------------------------ policy
@dataclasses.dataclass(frozen=True)
class PolicySpec(_Spec):
    """An expansion policy by registry name, plus the composition
    combinators: every ``veto`` must concur before an expansion is allowed
    (e.g. TwoTrack proposing with a GradientVariance veto holding the
    stage while the window's gradient still has signal); any ``any_of``
    member may force an expansion on its own."""
    name: str = "fixed_steps"
    params: dict = dataclasses.field(default_factory=dict)
    veto: tuple = ()
    any_of: tuple = ()

    def __post_init__(self):
        _set(self, params=dict(self.params),
             veto=tuple(PolicySpec.from_dict(v) if isinstance(v, dict) else v
                        for v in self.veto),
             any_of=tuple(PolicySpec.from_dict(v) if isinstance(v, dict)
                          else v for v in self.any_of))


# ---------------------------------------------------------------- optimizer
@dataclasses.dataclass(frozen=True)
class OptimizerSpec(_Spec):
    """An inner batch optimizer by registry name.  ``params`` are the
    optimizer dataclass's hyperparameters; ``"adamw_lm"`` is the LM train
    step (requires a :class:`ModelSpec` on the run)."""
    name: str = "newton_cg"
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        _set(self, params=dict(self.params))


# ----------------------------------------------------------------- schedule
@dataclasses.dataclass(frozen=True)
class ScheduleSpec(_Spec):
    """The stage schedule (BETSchedule: n_{t+1} = growth * n_t) plus the
    §4.2 simulated time model and the engine's stepping knobs.  ``clock``
    holds SimulatedClock parameters (``p``/``a``/``s``/``preloaded``);
    ``step_cost="batch"`` charges one mini-batch per inner step (the LM
    path) instead of the whole window (the convex drivers)."""
    n0: int = 200
    growth: float = 2.0
    clock: dict = dataclasses.field(default_factory=dict)
    step_cost: str = "window"       # window | batch
    wait_on_expand: bool = False
    carry_state: bool = False

    def __post_init__(self):
        _set(self, clock={str(k): float(v) if k != "preloaded" else int(v)
                          for k, v in dict(self.clock).items()})


# ----------------------------------------------------------------- topology
@dataclasses.dataclass(frozen=True)
class TopologySpec(_Spec):
    """Who the hosts are: ``hosts == 1`` is the single-host engine;
    ``kind="simulated"`` runs N logical hosts in one process (CI),
    ``kind="process"`` is one JAX process per host (a real pod)."""
    hosts: int = 1
    kind: str = "simulated"         # simulated | process


# ------------------------------------------------------------------ elastic
@dataclasses.dataclass(frozen=True)
class ElasticSpec(_Spec):
    """The fault-tolerance surface: deterministic fault injection
    (``"kind@stage:host[=delay]"`` strings, see elastic/faults.py), the
    straggler deadline flush, and lane headroom for tail reassignment.
    Setting any of these (or ``enabled=True``) routes a multi-host run
    through ``ElasticDataset``/``ElasticBetEngine``."""
    enabled: bool = False
    faults: tuple = ()
    straggler_deadline_s: float | None = None
    capacity_slack: float = 1.0
    worker_delays: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        _set(self, faults=tuple(str(f) for f in self.faults),
             worker_delays={int(k): float(v)
                            for k, v in dict(self.worker_delays).items()})

    @property
    def active(self) -> bool:
        return bool(self.enabled or self.faults or self.worker_delays
                    or self.straggler_deadline_s is not None
                    or self.capacity_slack > 1.0)


# --------------------------------------------------------------- checkpoint
@dataclasses.dataclass(frozen=True)
class CheckpointSpec(_Spec):
    """Stage-boundary checkpoints (elastic/checkpoint.StageCheckpointer).
    ``resume=True`` restores the latest checkpoint under ``directory``
    before running (bit-compatible cursor/clock/meter state)."""
    directory: str | None = None
    keep: int = 3
    every: int = 1
    resume: bool = False


# -------------------------------------------------------------------- serve
@dataclasses.dataclass(frozen=True)
class ServeSpec(_Spec):
    """The serve-while-you-train closed loop (``repro.serve``): synthetic
    traffic through the seed decode path, every served request logged into
    an online ingestion store, a traffic-driven policy expanding the BET
    window as requests land, and the server hot-swapping each published
    stage checkpoint.  Requires ``DataSpec(kind="lm", plane="plane")`` and
    a :class:`ModelSpec`; the logged row length must tile the training
    rows exactly: ``prompt_len + gen_tokens == data.seq_len + 1``
    (``gen_tokens=0`` derives it)."""
    enabled: bool = False
    requests_per_tick: int = 4      # prompt batch rows per serving tick
    prompt_len: int = 16
    gen_tokens: int = 0             # 0: derived as seq_len + 1 - prompt_len
    capacity: int = 0               # log bound; 0: data.corpus_size
    swap: bool = True               # poll + hot-swap stage checkpoints
    greedy: bool = True             # greedy decode (False: sampled)
    seed: int = 0


# ------------------------------------------------------------ observability
@dataclasses.dataclass(frozen=True)
class ObsSpec(_Spec):
    """The telemetry plane (``repro.obs``): structured stage spans/events,
    meter-wrapping metrics, the end-of-run :class:`~repro.obs.RunReport`,
    and opt-in profiling.  Off by default — with ``enabled=False`` the
    stack emits nothing and trajectories are bit-identical to an
    uninstrumented run.  ``dir`` lands ``events.jsonl`` (+ ``trace.json``
    when ``chrome_trace``, + ``report.json``/``report.txt`` when
    ``report``) after the run; ``profile`` wires the per-stage HLO cost
    estimator, and ``jax_profiler_dir`` additionally captures a
    ``jax.profiler`` trace.

    ``fleet`` (multi-host only) gives every simulated host its own event
    lane — ``dir`` then additionally lands one ``events_host<h>.jsonl``
    per host plus the causally-ordered merged trace ``fleet.jsonl`` (+
    ``fleet_trace.json`` when ``chrome_trace``) and the alignment summary
    ``fleet.json``.  ``health`` runs the live streaming detectors
    (``repro.obs.health``) over the stream and lands
    ``health.json``/``health.txt`` next to the RunReport; ``slo``
    overrides their thresholds (see ``repro.obs.health.SLO_DEFAULTS``)."""
    enabled: bool = False
    dir: str | None = None          # event log / trace / report directory
    chrome_trace: bool = False      # also export trace.json (Perfetto)
    report: bool = True             # write RunReport when dir is set
    profile: bool = False           # per-stage HLO FLOP/byte estimates
    jax_profiler_dir: str | None = None
    fleet: bool = False             # per-host event lanes + merged trace
    health: bool = False            # live health detectors + HealthReport
    slo: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        _set(self, slo=dict(self.slo))


# -------------------------------------------------------------------- model
@dataclasses.dataclass(frozen=True)
class ModelSpec(_Spec):
    """The LM architecture (configs registry name).  ``reduced`` builds
    the <=2-layer CPU smoke variant; ``overrides`` are ``ModelConfig``
    field overrides applied on top (e.g. a ~100M-param family member).
    ``family`` names the workload family adapter
    (``repro.workloads.FAMILIES``: transformer | mamba | rglru | moe) that
    supplies the train step / objective / param factories; ``"auto"``
    derives it from the architecture.  An explicit family that contradicts
    the arch fails eagerly at ``build()``."""
    arch: str = "qwen3-0.6b"
    reduced: bool = True
    overrides: dict = dataclasses.field(default_factory=dict)
    family: str = "auto"

    def __post_init__(self):
        _set(self, overrides=dict(self.overrides))


# ---------------------------------------------------------------------- run
@dataclasses.dataclass(frozen=True)
class RunSpec(_Spec):
    """One BET run, declaratively.  ``repro.api.build(spec)`` turns it
    into a :class:`~repro.api.session.Session`; ``to_dict``/``from_dict``
    make it a reproducible artifact."""
    name: str = "run"
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    policy: PolicySpec = dataclasses.field(default_factory=PolicySpec)
    optimizer: OptimizerSpec = dataclasses.field(
        default_factory=OptimizerSpec)
    schedule: ScheduleSpec = dataclasses.field(default_factory=ScheduleSpec)
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    elastic: ElasticSpec = dataclasses.field(default_factory=ElasticSpec)
    checkpoint: CheckpointSpec = dataclasses.field(
        default_factory=CheckpointSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    model: ModelSpec | None = None
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        _coerce(self, "data", DataSpec)
        _coerce(self, "policy", PolicySpec)
        _coerce(self, "optimizer", OptimizerSpec)
        _coerce(self, "schedule", ScheduleSpec)
        _coerce(self, "topology", TopologySpec)
        _coerce(self, "elastic", ElasticSpec)
        _coerce(self, "checkpoint", CheckpointSpec)
        _coerce(self, "serve", ServeSpec)
        _coerce(self, "obs", ObsSpec)
        if isinstance(self.model, dict):
            _set(self, model=ModelSpec.from_dict(self.model))
        _set(self, meta=dict(self.meta))
