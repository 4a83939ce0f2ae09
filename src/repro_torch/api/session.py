"""``build(RunSpec, device=...) -> Session`` — compose and drive the BET
stack the spec describes.

The port carries two branches on one device: the convex one, the paper's
own loop (a synthetic ``PAPER_LIKE`` problem, the Eq. 1 objective, a
ported inner optimizer and policy), and the LM one for every model family
of the reference (``workloads/families.py``).  Either serves its data
through the host-slice path (``DataSpec(plane="host")``) or the streaming
data plane (``plane="plane"``: shard stores, a prefetcher and a
device-resident window, ``data/plane.py``; for a convex run with
``TieringSpec(enabled=True)``, a tiered corpus whose hot window the HBM
budget bounds, ``data/tiers/``), and either writes stage
checkpoints (``CheckpointSpec``) that ``resume_session`` or
``Session.resume`` continue bit for bit.  ``TopologySpec(hosts=N)`` runs
either over N hosts (``dist/``: one plane per host over its owned shards,
the lanes of one stacked window, the collective stage flush), simulated
in this process; convex runs opt into the elastic runtime
(``elastic/``: faults, straggler rebalancing) with an ``ElasticSpec``,
and multi-host LM runs always run it, as in the reference.  ``build``
validates the spec eagerly: unknown names and invalid combinations fail
with a :class:`SpecError` as in the reference, and the branch a later
slice brings (one ``torch.distributed`` process per host) fails with a
:class:`SpecError` that names it.  ``ObsSpec`` wires one event
recorder through the stack (per-host lanes with ``fleet``, the live
detectors with ``health``, per-stage costs and a ``torch.profiler``
trace with ``profile``), as the reference's session does.  A serve spec is
refused as the reference refuses it, pointing at
``repro_torch.serve.build_loop``.  ``run(workload)`` builds and runs a
workload preset by name, serve presets through ``build_loop``.

``device`` is a keyword of ``build``, ``run``, ``resume_session`` and
``convex_problem``, not a spec field, so the ``RunSpec`` JSON schema
stays the reference's.  It defaults to ``"cuda"``; with no card, the call
raises rather than run on the CPU.
"""
from __future__ import annotations

import contextlib
import functools
import json
import pathlib
from typing import Callable

import numpy as np
import torch

from .. import configs
from ..core.engine import BETSchedule, BetEngine, StageEnd, StageInfo
from ..core.timemodel import SimulatedClock
from ..core.trace import Trace
from ..data.plane import StreamingDataset
from ..data.synthetic import PAPER_LIKE, Dataset, classification_arrays
from ..data.tiers import TieredCorpus
from ..data.window import synth_corpus
from ..device import resolve_device
from ..dist.collectives import DistributedObjective
from ..dist.runtime import DistributedBetEngine, DistributedDataset
from ..elastic import ElasticBetEngine, ElasticDataset, FaultPlan
from ..elastic.checkpoint import StageCheckpointer, peek_stage_meta
from ..models.common import ModelConfig
from ..models.linear import LOSSES, init_params, make_objective
from .lm import TokenWindows
from .registry import (LM_OPTIMIZER, OPTIMIZERS, STORES, TIERS, TOPOLOGIES,
                       build_optimizer, build_policy, make_store)
from .specs import DataSpec, ModelSpec, RunSpec, SpecError, TieringSpec


# ------------------------------------------------------------ convex problem
# serving-layer fields normalized out of the memo key: the same workload
# served through any serving layer is one problem
_SERVING_FIELDS = dict(plane="host", store="memory", workdir=None,
                       shard_size=64, delay_ms=0.0, prefetch_workers=1,
                       corpus_size=1024, seq_len=128, eval_rows=64,
                       tiering=TieringSpec())


@functools.lru_cache(maxsize=8)
def _convex_arrays(data: DataSpec) -> tuple:
    """The workload's numpy arrays ``(X, y, X_test, y_test)``, made from the
    seed once: the device tensors and the plane's shard stores both come
    from them."""
    if data.dataset not in PAPER_LIKE:
        raise SpecError(f"unknown convex dataset {data.dataset!r}; "
                        f"available: {sorted(PAPER_LIKE)}")
    if data.loss not in LOSSES:
        raise SpecError(f"unknown loss {data.loss!r}; "
                        f"available: {sorted(LOSSES)}")
    cfg = dict(PAPER_LIKE[data.dataset])
    cfg["n"] = max(64, int(cfg["n"] * data.scale))
    if data.condition_boost:
        cfg["condition"] = cfg.get("condition", 10.0) * 10
    cfg.update(dict(data.generator))
    return classification_arrays(seed=data.seed, **cfg)


@functools.lru_cache(maxsize=8)
def _convex_problem(data: DataSpec, device: str):
    arrays = _convex_arrays(data)
    ds = Dataset(data.dataset, *(torch.from_numpy(a).to(device)
                                 for a in arrays), spec=data.to_dict())
    objective = make_objective(data.loss, lam=data.lam)
    return ds, objective, init_params(ds.d, device=device)


def convex_problem(data: DataSpec, *, device="cuda"):
    """The convex workload a DataSpec names: ``(Dataset, objective, w0)``
    with the arrays on ``device``.

    Memoized per *workload* and device (serving-layer fields are
    normalized out of the key), so repeated sessions over the same problem
    share the dataset tensors and the objective."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:    # one key per card
        dev = torch.device("cuda", torch.cuda.current_device())
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

    # the branch a later slice brings
    if spec.topology.kind == "process" and hosts > 1:
        # each process would fill only its own lane of a whole stacked
        # window, and nothing yet all-reduces the objective, the LM
        # gradients or the stage records across processes
        raise _not_ported(
            "one torch.distributed process per host (TopologySpec("
            "kind='process', hosts > 1))",
            "the multi-process slice (ROADMAP queue A13)")

    # the reference's checks that apply to the ported branches
    STORES.get(d.store)
    TOPOLOGIES.get(spec.topology.kind)
    OPTIMIZERS.get(spec.optimizer.name)
    if spec.schedule.step_cost not in ("window", "batch"):
        raise SpecError(f"ScheduleSpec.step_cost must be 'window' or "
                        f"'batch', got {spec.schedule.step_cost!r}")
    if d.shard_size < 1 or d.prefetch_workers < 1:
        raise SpecError("shard_size and prefetch_workers must be >= 1")
    if d.delay_ms < 0:
        raise SpecError(f"delay_ms must be >= 0, got {d.delay_ms}")
    t = d.tiering
    if t.enabled:
        if d.plane != "plane":
            raise SpecError(
                "tiering needs the streaming plane (DataSpec.plane="
                "'plane'): the host-slice path has no device window to "
                "budget")
        if d.kind != "convex":
            raise SpecError("tiering currently serves the convex streaming "
                            "path only; the LM token plane is untiered")
        if t.hbm_bytes < 1:
            raise SpecError(f"TieringSpec.enabled needs hbm_bytes >= 1 "
                            f"(the hot-window byte budget), got "
                            f"{t.hbm_bytes}")
        if t.host_bytes < 0:
            raise SpecError(f"TieringSpec.host_bytes must be >= 0 "
                            f"(0 = unbounded ring), got {t.host_bytes}")
        if t.max_inflight is not None and t.max_inflight < 1:
            raise SpecError(f"TieringSpec.max_inflight must be >= 1 or "
                            f"None, got {t.max_inflight}")
        if hosts > 1:
            raise SpecError(
                "tiering is single-host for now: the rotation sweep is not "
                "SPMD-wired (per-lane hot windows would need a "
                "synchronized segment plan across hosts)")
        TIERS.get(t.manager)
    elif t.hbm_bytes or t.host_bytes or t.max_inflight is not None:
        raise SpecError(
            "TieringSpec budgets are set but enabled=False — enable "
            "tiering or drop the budgets (a silently untiered run would "
            "misreport the scaling study)")
    if hosts > 1:
        if d.plane == "host":
            raise SpecError(f"{hosts} hosts require the streaming plane "
                            f"(DataSpec.plane='plane'): the host-slice "
                            f"reference path is single-host only")
        if d.kind == "lm":
            batch = int(spec.optimizer.params.get("batch_size", 8))
            if batch % hosts:
                raise SpecError(
                    f"batch_size={batch} must split evenly over "
                    f"{hosts} hosts")
            if spec.schedule.n0 < hosts:
                raise SpecError(
                    f"n0={spec.schedule.n0} cannot give each of {hosts} "
                    f"hosts an example — per-host batch composition needs "
                    f"every lane non-empty from the first stage")
    e = spec.elastic
    if e.faults:
        plan = FaultPlan.parse(list(e.faults))      # grammar errors here
        for ev in plan.events:
            if ev.kind in ("kill", "slow") and ev.host >= hosts:
                raise SpecError(
                    f"fault {ev.kind}@{ev.stage}:{ev.host} targets host "
                    f"{ev.host} but the topology has {hosts} host(s)")
        if hosts == 1 and any(ev.kind == "kill" for ev in plan.events):
            raise SpecError(
                "a kill fault injects a *host* loss and needs hosts > 1; "
                "single-host restarts are the checkpoint resume path")
    if e.straggler_deadline_s is not None and hosts == 1:
        raise SpecError("a straggler deadline rebalances shards *between* "
                        "hosts and needs hosts > 1")
    if not e.capacity_slack >= 1.0:
        raise SpecError(f"capacity_slack must be >= 1, "
                        f"got {e.capacity_slack}")
    if spec.checkpoint.resume and not spec.checkpoint.directory:
        raise SpecError("CheckpointSpec.resume needs a checkpoint "
                        "directory (--ckpt-dir) to restore from")
    if spec.obs.fleet:
        if not spec.obs.enabled:
            raise SpecError("ObsSpec.fleet needs ObsSpec.enabled=True")
        if hosts < 2:
            raise SpecError(
                "ObsSpec.fleet records one event lane per host and aligns "
                "them at the stage-flush collectives — it needs hosts > 1 "
                "(single-host runs have one stream and no barriers)")
    if spec.obs.health and not spec.obs.enabled:
        raise SpecError("ObsSpec.health needs ObsSpec.enabled=True")
    if spec.obs.slo:
        from ..obs.health import SLO_DEFAULTS
        unknown = set(spec.obs.slo) - set(SLO_DEFAULTS)
        if unknown:
            raise SpecError(f"unknown ObsSpec.slo knobs {sorted(unknown)}; "
                            f"known: {sorted(SLO_DEFAULTS)}")

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
        # imported here: the family adapters import this package
        from ..workloads.families import resolve_family
        resolve_family(spec.model, lm_config(spec.model))
    elif spec.optimizer.name == LM_OPTIMIZER:
        raise SpecError(f"{LM_OPTIMIZER!r} is the LM train step; a convex "
                        f"run needs a batch optimizer "
                        f"({[n for n in OPTIMIZERS.names() if n != LM_OPTIMIZER]})")
    if spec.serve.enabled:
        raise SpecError(
            "ServeSpec.enabled describes the serve-while-you-train closed "
            "loop; build it with repro_torch.serve.build_loop(spec), not "
            "repro_torch.api.build — the training corpus is the live "
            "request log, which an offline session cannot reconstruct")


def _validate_policy(spec: RunSpec, policy) -> None:
    if policy.wants_variance:
        if spec.data.kind != "convex":
            raise SpecError(
                f"policy {policy.name!r} needs per-example gradients "
                f"(GradientVariance probes Var_i grad l_i over (X, y) "
                f"rows); the LM path has none")
        if spec.topology.hosts > 1:
            raise SpecError(
                f"policy {policy.name!r} is not SPMD-wired yet: "
                f"variance_stats unpacks (X, y), not HostWindows")
    if spec.data.tiering.enabled and \
            getattr(policy, "kind", None) == "two_track":
        raise SpecError(
            "policy 'two_track' trains a full-data track alongside the "
            "window track — exactly the residency a tiered corpus cannot "
            "provide; use a scan-stage policy with tiering")


def lm_config(model: ModelSpec) -> ModelConfig:
    """The ``ModelConfig`` a ModelSpec names: the registered architecture,
    ``configs.reduced`` when asked, then the overrides (a ``dtype``
    override may be a torch dtype's name, e.g. ``"float32"``, so the spec
    stays JSON)."""
    try:
        cfg = configs.get(model.arch)
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


def _make_checkpointer(spec: RunSpec) -> StageCheckpointer | None:
    ck = spec.checkpoint
    if not ck.directory:
        return None
    return StageCheckpointer(ck.directory, keep=ck.keep, every=ck.every,
                             spec=spec.to_dict())


def _make_topology(spec: RunSpec, device: torch.device):
    """The spec's host topology: N simulated hosts whose lanes all live on
    ``device``, or this ``torch.distributed`` process's host."""
    cls = TOPOLOGIES.get(spec.topology.kind)
    if spec.topology.kind == "simulated":
        return cls(spec.topology.hosts, devices=(device,))
    topo = cls(device=device)
    if topo.num_hosts != spec.topology.hosts:
        raise SpecError(
            f"TopologySpec.hosts={spec.topology.hosts} but the process "
            f"topology has {topo.num_hosts} torch.distributed processes")
    return topo


def _use_elastic(spec: RunSpec) -> bool:
    # the LM distributed path always runs the elastic runtime (identical
    # behavior without faults); convex runs opt in through ElasticSpec
    return spec.topology.hosts > 1 and \
        (spec.data.kind == "lm" or spec.elastic.active)


def _make_engine(spec: RunSpec, optimizer) -> BetEngine:
    kw = dict(
        schedule=BETSchedule(n0=spec.schedule.n0, growth=spec.schedule.growth),
        step_cost=_step_cost(spec, optimizer),
        wait_on_expand=spec.schedule.wait_on_expand,
        carry_state=spec.schedule.carry_state)
    if spec.topology.hosts == 1:
        return BetEngine(**kw)
    if not _use_elastic(spec):
        return DistributedBetEngine(**kw)
    faults = FaultPlan.parse(list(spec.elastic.faults)) \
        if spec.elastic.faults else None
    return ElasticBetEngine(faults=faults,
                            deadline_s=spec.elastic.straggler_deadline_s,
                            **kw)


def _distributed_dataset(spec: RunSpec, stores, device: torch.device):
    """The hosts' dataset over ``stores``: elastic when the spec asks for
    it (and always for an LM), each lane on ``device``."""
    kw = dict(topology=_make_topology(spec, device),
              growth=spec.schedule.growth,
              prefetch_workers=spec.data.prefetch_workers)
    if _use_elastic(spec):
        return ElasticDataset(
            stores, capacity_slack=spec.elastic.capacity_slack,
            worker_delays=spec.elastic.worker_delays, **kw)
    return DistributedDataset(stores, **kw)


def _stores(data: DataSpec, arrays: dict) -> list:
    return [make_store(data.store, arr, data.shard_size,
                       workdir=data.workdir, field=name,
                       delay_s=data.delay_ms * 1e-3)
            for name, arr in arrays.items()]


def _tiered_problem(data: DataSpec, device: torch.device):
    """A tiered run's ``(problem, objective, w0, eval_data, stores)``: the
    problem's tensors stay in host memory, and only the eval probe (the
    first ``eval_rows`` rows, as in the reference) and the parameters go
    to ``device`` — a tiered run must never make the whole corpus
    resident there."""
    arrays = _convex_arrays(data.replace(**_SERVING_FIELDS))
    ds = Dataset(data.dataset, *(torch.from_numpy(a) for a in arrays),
                 spec=data.to_dict())
    eval_data = tuple(torch.from_numpy(a[: data.eval_rows]).to(device)
                      for a in arrays[:2])
    stores = _stores(data, {"X": arrays[0], "y": arrays[1]})
    return (ds, make_objective(data.loss, lam=data.lam),
            init_params(ds.d, device=device), eval_data, stores)


def _build_convex(spec: RunSpec, policy, device: torch.device) -> "Session":
    data = spec.data
    t = data.tiering
    if t.enabled:
        ds, objective, w0, eval_data, stores = _tiered_problem(data, device)
        dataset = TieredCorpus(
            stores, hbm_bytes=t.hbm_bytes, host_bytes=t.host_bytes,
            growth=spec.schedule.growth,
            prefetch_workers=data.prefetch_workers,
            max_inflight=t.max_inflight, manager_cls=TIERS.get(t.manager),
            device=device)
        optimizer = build_optimizer(spec.optimizer)
        return Session(spec, dataset=dataset, optimizer=optimizer,
                       objective=objective, policy=policy,
                       engine=_make_engine(spec, optimizer),
                       clock=SimulatedClock(**spec.schedule.clock), w0=w0,
                       eval_data=eval_data,
                       checkpointer=_make_checkpointer(spec), problem=ds,
                       device=device)
    ds, objective, w0 = convex_problem(data, device=device)
    if data.plane == "plane":
        # the stores hold the generator's numpy arrays, never a copy of the
        # device tensors; full-data evals stay on (ds.X, ds.y), as in the
        # reference: the whole corpus on the device from the build on,
        # beside the window, its upload not metered
        X, y = _convex_arrays(data.replace(**_SERVING_FIELDS))[:2]
        stores = _stores(data, {"X": X, "y": y})
        if spec.topology.hosts > 1:
            objective = DistributedObjective(data.loss, data.lam)
            dataset = _distributed_dataset(spec, stores, device)
        else:
            dataset = StreamingDataset(
                stores, growth=spec.schedule.growth,
                prefetch_workers=data.prefetch_workers, device=device)
    else:
        dataset = ds
    optimizer = build_optimizer(spec.optimizer)
    return Session(spec, dataset=dataset, optimizer=optimizer,
                   objective=objective, policy=policy,
                   engine=_make_engine(spec, optimizer),
                   clock=SimulatedClock(**spec.schedule.clock), w0=w0,
                   eval_data=(ds.X, ds.y),
                   checkpointer=_make_checkpointer(spec), problem=ds,
                   device=device)


def _build_lm(spec: RunSpec, policy, device: torch.device) -> "Session":
    """The reference's LM build: the numpy corpus from ``data.seed``
    (bit-identical to the reference's) served through the host-slice path
    (``TokenWindows``), the streaming plane (a masked window) or, over N
    hosts, the elastic runtime's stacked lanes; an eval probe sliced from
    it on the host; and the family's parameters, train step and probe
    objective on ``device``."""
    data = spec.data
    hosts, n0 = spec.topology.hosts, spec.schedule.n0
    cfg = lm_config(spec.model)
    from ..workloads.families import resolve_family
    family = resolve_family(spec.model, cfg)
    corpus = synth_corpus(data.corpus_size, data.seq_len + 1,
                          max(2, cfg.vocab_size), seed=data.seed)
    # eval probe sliced on the host: the plane path must not ship the whole
    # corpus to the device just to build it — the DeviceWindow streams that
    eval_np = corpus[:: max(1, len(corpus) // data.eval_rows)][: data.eval_rows]
    if hosts > 1:
        # clamp shard granularity so every host owns a shard inside n0:
        # empty lanes would otherwise silently serve their zero padding
        # through rotation_rows/probe_rows for the early stages
        shard = min(data.shard_size, max(1, n0 // hosts))
        dataset = _distributed_dataset(
            spec, _stores(data.replace(shard_size=shard),
                          {"tokens": corpus}), device)
        full = dataset.ownership.min_full_participation_window()
        if full > n0:
            dataset.close()     # the failed build must not leak prefetchers
            raise SpecError(
                f"n0={n0} is below the smallest window in which every "
                f"host owns data ({full}); raise n0 or shrink "
                f"shard_size/hosts")
    elif data.plane == "plane":
        dataset = StreamingDataset(
            _stores(data, {"tokens": corpus}), masked=True,
            growth=spec.schedule.growth,
            prefetch_workers=data.prefetch_workers, device=device)
    else:
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
                   eval_data=eval_tokens,
                   checkpointer=_make_checkpointer(spec), device=device,
                   model_config=cfg)


def build(spec: RunSpec | dict, *, device="cuda") -> "Session":
    """Compose the stack a RunSpec describes on ``device``, validating
    eagerly."""
    if isinstance(spec, dict):
        spec = RunSpec.from_dict(spec)
    _validate(spec)
    dev = resolve_device(device)
    policy = build_policy(spec.policy)
    _validate_policy(spec, policy)
    if spec.data.kind == "lm":
        return _build_lm(spec, policy, dev)
    return _build_convex(spec, policy, dev)


# --------------------------------------------------------------------- resume
# the spec fields that determine what a checkpoint's numbers *mean*: the
# corpus and its serving layer, the host topology, the model shapes and the
# stage schedule.  A resume under different values of any of these would
# restore cursors/meters into a silently different run.
_RESUME_CRITICAL = ("data", "topology", "model", "schedule")


def check_resume_spec(spec: RunSpec, stored: dict) -> None:
    """Raise :class:`SpecError` when the caller-supplied spec disagrees
    with the spec stored in the checkpoint on any resume-critical field."""
    have = spec.to_dict()
    bad = [k for k in _RESUME_CRITICAL if have.get(k) != stored.get(k)]
    if bad:
        detail = "; ".join(
            f"{k}: checkpoint has {stored.get(k)!r}, caller has "
            f"{have.get(k)!r}" for k in bad)
        raise SpecError(
            f"resume spec mismatch on {bad}: the checkpoint was taken "
            f"under a different {'/'.join(bad)} configuration — resume "
            f"with repro_torch.api.resume_session(directory) to rebuild "
            f"from the stored spec, or fix the caller spec ({detail})")


def resume_session(directory, *, device="cuda") -> "Session":
    """Build a :class:`Session` on ``device`` entirely from the spec stored
    in the latest stage checkpoint under ``directory`` — the checkpoint,
    not the caller, says what the run is.  The session is returned ready
    to ``run()`` (its spec has ``checkpoint.resume=True``)."""
    d = pathlib.Path(directory)
    ckpts = sorted(d.glob("stage_*.npz"))
    if not ckpts:
        raise FileNotFoundError(f"no stage checkpoint under {d}")
    stored = peek_stage_meta(ckpts[-1].with_suffix("")).get("spec")
    if stored is None:
        raise SpecError(
            f"checkpoint {ckpts[-1]} carries no spec (it was saved by a "
            f"bare StageCheckpointer, not a Session) — rebuild the stack "
            f"explicitly and call Session.resume()")
    spec = RunSpec.from_dict(stored)
    if spec.serve.enabled:
        raise SpecError(
            "this checkpoint belongs to a serve-while-you-train run: its "
            "corpus is the live request log, which a spec rebuild cannot "
            "regenerate — restore through "
            "repro_torch.elastic.checkpoint.load_stage_checkpoint over the "
            "closed log instead")
    spec = spec.replace(checkpoint=spec.checkpoint.replace(
        directory=str(d), resume=True))
    return build(spec, device=device)


# ------------------------------------------------------------------ workloads
def run(workload: "str | RunSpec", *, device="cuda",
        progress: Callable | None = None, probe: Callable | None = None):
    """One string, one run: ``repro_torch.api.run("falcon-mamba@stream")``.

    ``workload`` is a preset name from the ``WORKLOADS`` registry (or any
    ``arch@scenario`` string the workload grammar parses — see
    ``repro_torch.workloads``), or an explicit :class:`RunSpec`.  Offline
    specs build a :class:`Session` on ``device``, run it, and return the
    session with its ``trace`` populated; serve-enabled specs route
    through ``repro_torch.serve.build_loop`` and return the finished
    ``ServeTrainLoop`` (its trace under ``.trace``, its RunReport under
    ``.run_report``)."""
    if isinstance(workload, str):
        from ..workloads import get_workload
        workload = get_workload(workload).spec()
    if workload.serve.enabled:
        from ..serve import build_loop
        loop = build_loop(workload, device=device)
        loop.run()
        return loop
    session = build(workload, device=device)
    session.run(progress=progress, probe=probe)
    return session


# -------------------------------------------------------------------- session
class Session:
    """The composed BET stack for one RunSpec.

    Components are public (``dataset``, ``optimizer``, ``objective``,
    ``policy``, ``engine``, ``clock``) so drivers and tests can instrument
    them before ``run()``; the session owns their lifecycle (the data
    plane is closed when the run finishes, even on error).

    A session drives one run: ``run()`` (or ``resume()``, which ``run()``
    delegates to when the spec says so) executes the schedule and leaves
    the result in ``trace``; ``stage_ends`` records every stage boundary,
    and ``on_stage(cb)`` registers extra boundary callbacks (after the
    checkpointer)."""

    def __init__(self, spec: RunSpec, *, dataset, optimizer, objective,
                 policy, engine, clock, w0, eval_data, checkpointer=None,
                 problem=None, device=None, model_config=None):
        self.spec = spec
        self.dataset = dataset
        self.optimizer = optimizer
        self.objective = objective
        self.policy = policy
        self.engine = engine
        self.clock = clock
        self.w0 = w0
        self.eval_data = eval_data
        self.checkpointer = checkpointer
        self.problem = problem          # convex: the synthetic Dataset
        self.device = device
        self.model_config = model_config    # LM: the ModelConfig
        self.trace: Trace | None = None
        self.restored = None            # RestoredRun after resume()
        self.stage_ends: list[dict] = []
        self._callbacks: list[Callable] = []
        engine.stage_callback = self._stage_end
        self.recorder = None            # EventRecorder when obs is enabled
        self.health = None              # HealthMonitor when obs.health
        if spec.obs.enabled:
            self._wire_obs()

    # -------------------------------------------------------- observability
    def _wire_obs(self) -> None:
        """One recorder through the whole stack: engine stage spans, data
        plane meters/prefetchers, the simulated clock and the checkpointer
        all emit into the same totally-ordered stream.

        With ``obs.fleet`` the recorder is a :class:`FleetRecorder`:
        driver-side events keep flowing through it (into the driver lane)
        while ``attach_dataset`` routes each host's meter/prefetcher into
        that host's own lane — one stream per host, merged after the run.
        With ``obs.health`` a :class:`HealthMonitor` taps every lane and
        runs the streaming detectors while the run is live.  With
        ``obs.profile`` a :class:`StageProfiler` costs each stage's step
        on meta tensors."""
        obs = self.spec.obs
        if obs.fleet:
            from ..obs.fleet import FleetRecorder
            rec = FleetRecorder(hosts=range(self.spec.topology.hosts))
        else:
            from ..obs import EventRecorder
            rec = EventRecorder()
        from ..obs.metrics import attach_clock, attach_dataset
        self.recorder = rec
        self.engine.recorder = rec
        attach_dataset(self.dataset, rec)
        attach_clock(self.clock, rec)
        if self.checkpointer is not None:
            self.checkpointer.recorder = rec
        if obs.health:
            from ..obs.health import HealthMonitor
            self.health = HealthMonitor(slo=obs.slo)
            self.health.attach(rec)
        if obs.profile:
            from ..obs.profile import StageProfiler
            self.engine.profiler = StageProfiler(rec)

    def run_report(self):
        """The :class:`~repro_torch.obs.report.RunReport` over this
        session's event stream (needs ``RunSpec.obs.enabled``)."""
        if self.recorder is None:
            raise SpecError("run_report needs observability: set "
                            "RunSpec.obs.enabled=True before build()")
        from ..obs import RunReport
        from ..obs.fleet import FleetRecorder
        if isinstance(self.recorder, FleetRecorder):
            # the meters live in the host lanes — fold over the merged
            # stream so the claims see every lane's traffic
            return RunReport(self.recorder.merged().events)
        return RunReport.from_recorder(self.recorder)

    def health_report(self):
        """The live :class:`~repro_torch.obs.health.HealthReport` (needs
        ``RunSpec.obs.health``)."""
        if self.health is None:
            raise SpecError("health_report needs the live detectors: set "
                            "RunSpec.obs.health=True before build()")
        return self.health.report()

    def fleet_trace(self):
        """The merged per-host :class:`~repro_torch.obs.fleet.FleetTrace`
        (needs ``RunSpec.obs.fleet``)."""
        from ..obs.fleet import FleetRecorder
        if not isinstance(self.recorder, FleetRecorder):
            raise SpecError("fleet_trace needs per-host lanes: set "
                            "RunSpec.obs.fleet=True before build()")
        return self.recorder.merged()

    def _emit_run_meta(self) -> None:
        stores = getattr(self.dataset, "stores", None) or ()
        row_bytes = sum(int(getattr(s, "example_nbytes", 0)) for s in stores)
        self.recorder.instant("run.meta", fields={
            "name": self.spec.name, "n": int(self.dataset.n),
            "hosts": self.spec.topology.hosts,
            "policy": self.spec.policy.name,
            "n0": self.spec.schedule.n0, "growth": self.spec.schedule.growth,
            "row_bytes": row_bytes})

    def _write_obs(self) -> dict:
        obs = self.spec.obs
        d = pathlib.Path(obs.dir)
        d.mkdir(parents=True, exist_ok=True)
        from ..obs.fleet import FleetRecorder
        if isinstance(self.recorder, FleetRecorder):
            # one JSONL per lane + the causally-ordered merged trace
            out = {"lanes": self.recorder.save(d)}
            merged = self.recorder.merged()
            out["fleet"] = str(d / "fleet.jsonl")
            merged.to_jsonl(out["fleet"])
            out["fleet_summary"] = str(d / "fleet.json")
            with open(out["fleet_summary"], "w") as fh:
                json.dump(merged.summary(), fh, indent=2)
            # events.jsonl stays the driver stream, as in the reference
            out["events"] = str(d / "events.jsonl")
            self.recorder.driver.to_jsonl(out["events"])
            if obs.chrome_trace:
                out["trace"] = str(d / "fleet_trace.json")
                merged.to_chrome_trace(out["trace"])
        else:
            out = {"events": str(d / "events.jsonl")}
            self.recorder.to_jsonl(out["events"])
            if obs.chrome_trace:
                out["trace"] = str(d / "trace.json")
                self.recorder.to_chrome_trace(out["trace"])
        if obs.report:
            out.update(self.run_report().save(d))
        if self.health is not None:
            out.update(self.health.report().save(d))
        return out

    # ------------------------------------------------------------- boundaries
    def on_stage(self, callback: Callable[[StageEnd], None]) -> None:
        """Register an extra stage-boundary callback (runs after the
        checkpointer, in registration order)."""
        self._callbacks.append(callback)

    def _stage_end(self, end: StageEnd) -> None:
        self.stage_ends.append({
            "stage": end.info.stage, "n_t": end.info.n_t,
            "n_next": end.info.n_next, "is_final": end.info.is_final,
            "step_count": end.step_count, "stages": end.stages,
            "transfers": end.transfers, "overshoot": end.overshoot})
        if self.checkpointer is not None:
            self.checkpointer(end)
        for cb in self._callbacks:
            cb(end)

    def stage_plan(self) -> list[StageInfo]:
        """The stages the schedule + policy will run (before running)."""
        return self.engine.stage_infos(self.policy, self.dataset.n)

    # -------------------------------------------------------------- execution
    def run(self, *, progress: Callable | None = None,
            probe: Callable | None = None) -> Trace:
        """Execute the run the spec describes (resuming when the spec's
        CheckpointSpec says so) and return the trace.  ``probe(w)`` is the
        engine's per-step measurement hook (it gets the host copy of each
        step's parameters)."""
        if self.spec.checkpoint.resume:
            return self.resume(progress=progress, probe=probe)
        return self._run(progress=progress, probe=probe,
                         run_kw={"w0": self.w0})

    def resume(self, *, progress: Callable | None = None,
               probe: Callable | None = None) -> Trace:
        """Restore the latest stage checkpoint and continue the schedule
        (bit-compatible cursor/clock/meter state; the restart's re-read is
        reported as ``trace.meta['resume_rewarm']``)."""
        if self.checkpointer is None:
            raise SpecError("resume needs CheckpointSpec.directory")
        latest = self.checkpointer.latest()
        if latest is None:
            raise FileNotFoundError(
                f"resume: no stage checkpoint under "
                f"{self.spec.checkpoint.directory}")
        # the checkpoint's stored spec, not the caller's word, decides
        # whether this session matches the checkpointed run
        stored = peek_stage_meta(latest).get("spec")
        if stored is not None:
            check_resume_spec(self.spec, stored)
        restored = self.checkpointer.restore(
            self.w0, self.optimizer.init(self.w0))
        self.restored = restored
        restored.restore_clock(self.clock)
        rewarm = restored.restore_dataset(self.dataset)
        trace = self._run(progress=progress, probe=probe, run_kw={
            "w0": restored.params, "opt_state0": restored.opt_state,
            "resume": restored.resume})
        trace.meta["resume_rewarm"] = rewarm
        return trace

    def _run(self, *, progress, probe, run_kw) -> Trace:
        spec = self.spec
        meta = dict(spec.meta)
        if self.model_config is not None:
            meta.setdefault("arch", self.model_config.name)
        prof = contextlib.nullcontext()
        if self.recorder is not None:
            self._emit_run_meta()
            if spec.obs.jax_profiler_dir:
                from ..obs.profile import profiler_trace
                prof = profiler_trace(spec.obs.jax_profiler_dir)
        try:
            with prof:
                trace = self.engine.run(
                    self.dataset, self.optimizer, self.objective,
                    self.policy, clock=self.clock, eval_data=self.eval_data,
                    trace_name=None if spec.name == "run" else spec.name,
                    meta=meta or None, progress=progress, probe=probe,
                    **run_kw)
        finally:
            self.close()
        meter = getattr(self.dataset, "meter", None)
        if meter is not None:
            trace.meta["data_plane"] = meter.snapshot()
        if hasattr(self.dataset, "tier_meter"):
            trace.meta["tiers"] = self.dataset.tier_report()
        if isinstance(self.dataset, DistributedDataset):
            trace.meta["data_plane_hosts"] = {
                h: self.dataset.host_meters[h].snapshot()
                for h in self.dataset.planes}
        if self.recorder is not None and spec.obs.dir:
            trace.meta["obs_files"] = self._write_obs()
        self.trace = trace
        return trace

    # ------------------------------------------------------------------ state
    @property
    def meters(self) -> dict:
        """Clock + real-I/O accounting snapshots (Thm 4.1's counters)."""
        out = {"clock": self.clock.snapshot()}
        meter = getattr(self.dataset, "meter", None)
        if meter is not None:
            out["data_plane"] = meter.snapshot()
        if hasattr(self.dataset, "tier_meter"):
            out["tiers"] = self.dataset.tier_meter.snapshot()
        if isinstance(self.dataset, DistributedDataset):
            out["hosts"] = {h: self.dataset.host_meters[h].snapshot()
                            for h in self.dataset.planes}
        return out

    def close(self) -> None:
        close = getattr(self.dataset, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
