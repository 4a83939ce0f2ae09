"""``build(RunSpec, device=...) -> Session`` — compose and drive the BET
stack the spec describes.

The port carries two branches on one device: the convex one, the paper's
own loop (a synthetic ``PAPER_LIKE`` problem, the Eq. 1 objective, a
ported inner optimizer and policy), and the LM one on the host-slice
token path (``DataSpec(kind="lm", plane="host")``) for the model families
ported so far (``workloads/families.py``).  ``build`` validates the spec
eagerly: unknown names and invalid combinations fail with a
:class:`SpecError` as in the reference, and every branch a later slice
brings (the streaming plane, multiple hosts, tiering, elastic faults,
checkpoints, observability, serving, the other model families) fails
with a :class:`SpecError` that names it.

``device`` is a keyword of ``build`` and ``convex_problem``, not a spec
field, so the ``RunSpec`` JSON schema stays the reference's.  It defaults
to ``"cuda"``; with no card, the call raises rather than run on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from .. import configs
from ..core.engine import BETSchedule, BetEngine, StageEnd, StageInfo
from ..core.timemodel import SimulatedClock
from ..core.trace import Trace
from ..data.synthetic import PAPER_LIKE, load, make_classification
from ..data.window import synth_corpus
from ..device import resolve_device
from ..models.common import ModelConfig
from ..models.linear import LOSSES, init_params, make_objective
from ..workloads.families import resolve_family
from .lm import TokenWindows
from .registry import LM_OPTIMIZER, OPTIMIZERS, build_optimizer, build_policy
from .specs import DataSpec, ModelSpec, RunSpec, SpecError, TieringSpec


# ------------------------------------------------------------ convex problem
# serving-layer fields normalized out of the memo key: the same workload
# served through any serving layer is one problem
_SERVING_FIELDS = dict(plane="host", store="memory", workdir=None,
                       shard_size=64, delay_ms=0.0, prefetch_workers=1,
                       corpus_size=1024, seq_len=128, eval_rows=64,
                       tiering=TieringSpec())


@functools.lru_cache(maxsize=8)
def _convex_problem(data: DataSpec, device: str):
    if data.dataset not in PAPER_LIKE:
        raise SpecError(f"unknown convex dataset {data.dataset!r}; "
                        f"available: {sorted(PAPER_LIKE)}")
    if data.loss not in LOSSES:
        raise SpecError(f"unknown loss {data.loss!r}; "
                        f"available: {sorted(LOSSES)}")
    if data.condition_boost or data.generator:
        cfg = dict(PAPER_LIKE[data.dataset])
        cfg["n"] = max(64, int(cfg["n"] * data.scale))
        if data.condition_boost:
            cfg["condition"] = cfg.get("condition", 10.0) * 10
        cfg.update(dict(data.generator))
        ds = make_classification(data.dataset, seed=data.seed, device=device,
                                 **cfg)
    else:
        ds = load(data.dataset, seed=data.seed, scale=data.scale,
                  device=device)
    ds = dataclasses.replace(ds, spec=data.to_dict())
    objective = make_objective(data.loss, lam=data.lam)
    return ds, objective, init_params(ds.d, device=device)


def convex_problem(data: DataSpec, *, device="cuda"):
    """The convex workload a DataSpec names: ``(Dataset, objective, w0)``
    with the arrays on ``device``.

    Memoized per *workload* and device (serving-layer fields are
    normalized out of the key), so repeated sessions over the same problem
    share the dataset tensors and the objective."""
    dev = resolve_device(device)
    return _convex_problem(data.replace(**_SERVING_FIELDS), str(dev))


# ---------------------------------------------------------------- validation
def _not_ported(what: str, where: str) -> SpecError:
    return SpecError(f"{what} is not yet ported to repro_torch; it comes "
                     f"with {where}")


def _validate(spec: RunSpec) -> None:
    d, hosts = spec.data, spec.topology.hosts
    if d.kind not in ("convex", "lm"):
        raise SpecError(f"DataSpec.kind must be 'convex' or 'lm', "
                        f"got {d.kind!r}")
    if d.plane not in ("host", "plane"):
        raise SpecError(f"DataSpec.plane must be 'host' or 'plane', "
                        f"got {d.plane!r}")
    if hosts < 1:
        raise SpecError(f"TopologySpec.hosts must be >= 1, got {hosts}")

    # branches later slices bring
    if d.plane == "plane":
        raise _not_ported("the streaming data plane (DataSpec.plane="
                          "'plane')", "the data-plane slice (ROADMAP "
                          "queue A6)")
    if hosts > 1:
        raise _not_ported(f"a {hosts}-host topology",
                          "the distributed slice (ROADMAP queue A8)")
    if d.tiering.enabled:
        raise _not_ported("tiering (TieringSpec.enabled)",
                          "the tiered-corpus slice (ROADMAP queue A11)")
    if spec.elastic.active:
        raise _not_ported("elastic fault tolerance (ElasticSpec)",
                          "the elastic slice (ROADMAP queue A7)")
    if spec.checkpoint.directory or spec.checkpoint.resume:
        raise _not_ported("stage checkpoints (CheckpointSpec)",
                          "the elastic slice (ROADMAP queue A7)")
    if spec.obs.enabled or spec.obs.fleet or spec.obs.health:
        raise _not_ported("observability (ObsSpec)",
                          "the observability slice (ROADMAP queue A11)")
    if spec.serve.enabled:
        raise _not_ported("serve-while-you-train (ServeSpec)",
                          "the serve slice (ROADMAP queue A11)")

    # the reference's checks that apply to a convex single-host run
    if d.store not in ("memory", "memmap"):
        raise SpecError(f"unknown store {d.store!r}; registered names: "
                        f"['memmap', 'memory']")
    if spec.topology.kind not in ("simulated", "process"):
        raise SpecError(f"unknown topology {spec.topology.kind!r}; "
                        f"registered names: ['process', 'simulated']")
    OPTIMIZERS.get(spec.optimizer.name)
    if spec.schedule.step_cost not in ("window", "batch"):
        raise SpecError(f"ScheduleSpec.step_cost must be 'window' or "
                        f"'batch', got {spec.schedule.step_cost!r}")
    if d.shard_size < 1 or d.prefetch_workers < 1:
        raise SpecError("shard_size and prefetch_workers must be >= 1")
    if d.delay_ms < 0:
        raise SpecError(f"delay_ms must be >= 0, got {d.delay_ms}")
    t = d.tiering
    if t.hbm_bytes or t.host_bytes or t.max_inflight is not None:
        raise SpecError(
            "TieringSpec budgets are set but enabled=False — enable "
            "tiering or drop the budgets (a silently untiered run would "
            "misreport the scaling study)")
    if not spec.elastic.capacity_slack >= 1.0:
        raise SpecError(f"capacity_slack must be >= 1, "
                        f"got {spec.elastic.capacity_slack}")

    if d.kind == "lm":
        if spec.model is None:
            raise SpecError("an LM run needs a ModelSpec (RunSpec.model)")
        if spec.optimizer.name != LM_OPTIMIZER:
            raise SpecError(
                f"the LM path trains through the {LM_OPTIMIZER!r} "
                f"optimizer, got {spec.optimizer.name!r}")
        bad = set(spec.optimizer.params) - {"lr", "batch_size"}
        if bad:
            raise SpecError(f"{LM_OPTIMIZER!r} accepts params 'lr' and "
                            f"'batch_size', not {sorted(bad)}")
        # family adapter resolution is itself an eager check: an explicit
        # family that contradicts the arch fails here, not in the train step
        resolve_family(spec.model, lm_config(spec.model))
    elif spec.optimizer.name == LM_OPTIMIZER:
        raise SpecError(f"{LM_OPTIMIZER!r} is the LM train step; a convex "
                        f"run needs a batch optimizer "
                        f"({[n for n in OPTIMIZERS.names() if n != LM_OPTIMIZER]})")


def lm_config(model: ModelSpec) -> ModelConfig:
    """The ``ModelConfig`` a ModelSpec names: the registered architecture,
    ``configs.reduced`` when asked, then the overrides (a ``dtype``
    override may be a torch dtype's name, e.g. ``"float32"``, so the spec
    stays JSON)."""
    try:
        cfg = configs.get(model.arch)
    except configs.NotPortedError as e:
        raise SpecError(str(e)) from None
    except KeyError:
        raise SpecError(f"unknown arch {model.arch!r}; available: "
                        f"{sorted(configs.ALIASES)}") from None
    if model.reduced:
        cfg = configs.reduced(cfg)
    if model.overrides:
        try:
            cfg = cfg.with_(**model.overrides)
        except TypeError as e:
            raise SpecError(f"ModelSpec.overrides: {e}") from None
    if isinstance(cfg.dtype, str):
        dtype = getattr(torch, cfg.dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise SpecError(f"ModelSpec.overrides: dtype {cfg.dtype!r} is "
                            f"not a torch dtype")
        cfg = cfg.with_(dtype=dtype)
    return cfg


# --------------------------------------------------------------- components
def _step_cost(spec: RunSpec, optimizer) -> Callable[[int], int] | None:
    if spec.schedule.step_cost == "window":
        return None                     # engine default: the whole window
    batch = getattr(optimizer, "batch_size", None)
    if batch is None:
        raise SpecError(
            f"step_cost='batch' needs an optimizer with a batch_size "
            f"({type(optimizer).__name__} has none)")
    return lambda n_t: batch


def _make_engine(spec: RunSpec, optimizer) -> BetEngine:
    return BetEngine(
        schedule=BETSchedule(n0=spec.schedule.n0, growth=spec.schedule.growth),
        step_cost=_step_cost(spec, optimizer),
        wait_on_expand=spec.schedule.wait_on_expand,
        carry_state=spec.schedule.carry_state)


def _build_convex(spec: RunSpec, policy, device: torch.device) -> "Session":
    ds, objective, w0 = convex_problem(spec.data, device=device)
    optimizer = build_optimizer(spec.optimizer)
    return Session(spec, dataset=ds, optimizer=optimizer,
                   objective=objective, policy=policy,
                   engine=_make_engine(spec, optimizer),
                   clock=SimulatedClock(**spec.schedule.clock), w0=w0,
                   eval_data=(ds.X, ds.y), problem=ds, device=device)


def _build_lm(spec: RunSpec, policy, device: torch.device) -> "Session":
    """The reference's host-plane LM build (``TokenWindows``): the numpy
    corpus from ``data.seed`` (bit-identical to the reference's), an eval
    probe sliced from it on the host, and the family's parameters, train
    step and probe objective on ``device``."""
    data = spec.data
    cfg = lm_config(spec.model)
    family = resolve_family(spec.model, cfg)
    corpus = synth_corpus(data.corpus_size, data.seq_len + 1,
                          max(2, cfg.vocab_size), seed=data.seed)
    eval_np = corpus[:: max(1, len(corpus) // data.eval_rows)][: data.eval_rows]
    dataset = TokenWindows(torch.from_numpy(corpus).to(device))
    eval_tokens = torch.from_numpy(np.ascontiguousarray(eval_np)).to(device)
    params = family.build_params(cfg, data.seed, device=device)
    optimizer = family.step(
        cfg, lr=float(spec.optimizer.params.get("lr", 1e-3)),
        batch_size=int(spec.optimizer.params.get("batch_size", 8)))
    # clamp the probe to the eval set so a small eval block is an unweighted
    # mean over distinct rows; stage windows below that size wrap instead
    objective = family.objective(cfg, min(data.eval_rows, len(eval_np)))
    return Session(spec, dataset=dataset, optimizer=optimizer,
                   objective=objective, policy=policy,
                   engine=_make_engine(spec, optimizer),
                   clock=SimulatedClock(**spec.schedule.clock), w0=params,
                   eval_data=eval_tokens, device=device, model_config=cfg)


def build(spec: RunSpec | dict, *, device="cuda") -> "Session":
    """Compose the stack a RunSpec describes on ``device``, validating
    eagerly."""
    if isinstance(spec, dict):
        spec = RunSpec.from_dict(spec)
    _validate(spec)
    dev = resolve_device(device)
    policy = build_policy(spec.policy)
    if spec.data.kind == "lm":
        return _build_lm(spec, policy, dev)
    return _build_convex(spec, policy, dev)


# -------------------------------------------------------------------- session
class Session:
    """The composed BET stack for one RunSpec.

    Components are public (``dataset``, ``optimizer``, ``objective``,
    ``policy``, ``engine``, ``clock``) so drivers and tests can instrument
    them before ``run()``.  A session drives one run: ``run()`` executes
    the schedule and leaves the result in ``trace``; ``stage_ends``
    records every stage boundary."""

    def __init__(self, spec: RunSpec, *, dataset, optimizer, objective,
                 policy, engine, clock, w0, eval_data, problem=None,
                 device=None, model_config=None):
        self.spec = spec
        self.dataset = dataset
        self.optimizer = optimizer
        self.objective = objective
        self.policy = policy
        self.engine = engine
        self.clock = clock
        self.w0 = w0
        self.eval_data = eval_data
        self.problem = problem          # convex: the synthetic Dataset
        self.device = device
        self.model_config = model_config    # LM: the ModelConfig
        self.trace: Trace | None = None
        self.stage_ends: list[dict] = []
        engine.stage_callback = self._stage_end

    def _stage_end(self, end: StageEnd) -> None:
        self.stage_ends.append({
            "stage": end.info.stage, "n_t": end.info.n_t,
            "n_next": end.info.n_next, "is_final": end.info.is_final,
            "step_count": end.step_count, "stages": end.stages,
            "transfers": end.transfers, "overshoot": end.overshoot})

    def stage_plan(self) -> list[StageInfo]:
        """The stages the schedule + policy will run (before running)."""
        return self.engine.stage_infos(self.policy, self.dataset.n)

    # -------------------------------------------------------------- execution
    def run(self, *, progress: Callable | None = None,
            probe: Callable | None = None) -> Trace:
        """Execute the run the spec describes and return the trace.
        ``probe(w)`` is the engine's per-step measurement hook (it gets the
        host copy of each step's parameters)."""
        spec = self.spec
        meta = dict(spec.meta)
        if self.model_config is not None:
            meta.setdefault("arch", self.model_config.name)
        self.trace = self.engine.run(
            self.dataset, self.optimizer, self.objective, self.policy,
            w0=self.w0, clock=self.clock, eval_data=self.eval_data,
            trace_name=None if spec.name == "run" else spec.name,
            meta=meta or None, progress=progress, probe=probe)
        return self.trace

