"""Named registries — every policy, optimizer, shard store, tier manager,
topology and workload preset of the port is addressable from a spec by
name.

Registries are plain name -> factory tables with clear unknown-name
errors; the ``register_*`` hooks let downstream code add components
without touching this module (a new workload becomes a spec, not a new
script), as the reference's do.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any

from ..core.engine import (ComposedPolicy, ExpansionPolicy, FixedSteps,
                           GradientVariance, NeverExpand, TwoTrack)
from ..data.shards import InMemoryShardStore, MemmapShardStore, ThrottledStore
from ..data.tiers import RingTierManager
from ..dist.topology import ProcessTopology, SimulatedTopology
from ..optim import REGISTRY as _OPTIM_REGISTRY
from ..optim.api import BatchOptimizer
from ..serve.policy import TrafficDriven
from .specs import OptimizerSpec, PolicySpec, SpecError


class Registry:
    """A name -> factory table with actionable lookup errors."""

    def __init__(self, kind: str, entries: dict[str, Any] | None = None):
        self.kind = kind
        self._entries: dict[str, Any] = dict(entries or {})

    def register(self, name: str, factory: Any) -> Any:
        self._entries[name] = factory
        return factory

    def names(self) -> list[str]:
        return sorted(self._entries)

    def items(self):
        return self._entries.items()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            close = difflib.get_close_matches(str(name), self._entries,
                                              n=3, cutoff=0.5)
            hint = f" did you mean {', '.join(map(repr, close))}?" \
                if close else ""
            raise SpecError(
                f"unknown {self.kind} {name!r};{hint} registered names: "
                f"{sorted(self._entries)}") from None


# ----------------------------------------------------------------- policies
POLICIES = Registry("policy", {
    "batch": NeverExpand,
    "never_expand": NeverExpand,
    "bet": FixedSteps,
    "fixed_steps": FixedSteps,
    "two_track": TwoTrack,
    "bet_gradvar": GradientVariance,
    "gradient_variance": GradientVariance,
    "traffic_driven": TrafficDriven,
})

# --------------------------------------------------------------- optimizers
# "adamw_lm" marks the LM train-step optimizer: it is built by the session
# (it needs the ModelSpec's train step), not by a bare params call.
LM_OPTIMIZER = "adamw_lm"
OPTIMIZERS = Registry("optimizer",
                      {**_OPTIM_REGISTRY, LM_OPTIMIZER: LM_OPTIMIZER})

# ------------------------------------------------------------------- stores
STORES = Registry("store", {
    "memory": InMemoryShardStore,
    "memmap": MemmapShardStore,
})

# ------------------------------------------------------------ tier managers
# name -> tier manager class (data.tiers): decides which rows of the
# expanding window are HBM-hot under a byte budget; named by
# TieringSpec.manager
TIERS = Registry("tier manager", {
    RingTierManager.name: RingTierManager,
})

# --------------------------------------------------------------- topologies
TOPOLOGIES = Registry("topology", {
    "simulated": SimulatedTopology,
    "process": ProcessTopology,
})

# ---------------------------------------------------------------- workloads
# name -> WorkloadPreset (its ``spec()`` composes the RunSpec).  Populated
# by repro_torch.workloads.presets on import; ``session.run`` and the CLI
# pull from here.
WORKLOADS = Registry("workload")


def register_policy(name: str, cls) -> Any:
    return POLICIES.register(name, cls)


def register_optimizer(name: str, cls) -> Any:
    return OPTIMIZERS.register(name, cls)


def register_store(name: str, cls) -> Any:
    return STORES.register(name, cls)


def register_tier_manager(name: str, cls) -> Any:
    return TIERS.register(name, cls)


def register_workload(name: str, preset) -> Any:
    return WORKLOADS.register(name, preset)


# ----------------------------------------------------------------- builders
def build_policy(spec: PolicySpec) -> ExpansionPolicy:
    """PolicySpec -> ExpansionPolicy, recursively composing veto/any_of
    members through :class:`~repro_torch.core.engine.ComposedPolicy`."""
    cls = POLICIES.get(spec.name)
    try:
        primary = cls(**spec.params)
    except TypeError as e:
        raise SpecError(f"policy {spec.name!r}: {e}") from None
    if not (spec.veto or spec.any_of):
        return primary
    try:
        return ComposedPolicy(primary,
                              vetoes=[build_policy(v) for v in spec.veto],
                              any_of=[build_policy(v) for v in spec.any_of])
    except ValueError as e:
        raise SpecError(f"policy composition: {e}") from None


def build_optimizer(spec: OptimizerSpec) -> BatchOptimizer:
    """OptimizerSpec -> BatchOptimizer."""
    cls = OPTIMIZERS.get(spec.name)
    if cls == LM_OPTIMIZER:
        raise SpecError(
            f"optimizer {spec.name!r} is the LM train step: it needs a "
            f"ModelSpec and is built by the session, not standalone")
    try:
        return cls(**spec.params)
    except TypeError as e:
        raise SpecError(f"optimizer {spec.name!r}: {e}") from None


def optimizer_spec_of(opt: BatchOptimizer) -> OptimizerSpec:
    """The spec a concrete optimizer instance round-trips through —
    drivers hand pre-built optimizers to the spec'd sessions with this."""
    if opt.name == LM_OPTIMIZER:
        raise SpecError(
            f"{LM_OPTIMIZER!r} instances hold model closures that cannot "
            f"round-trip through a spec; describe the LM optimizer as "
            f"OptimizerSpec('{LM_OPTIMIZER}', {{'lr': ..., "
            f"'batch_size': ...}}) instead")
    if opt.name not in OPTIMIZERS:
        raise SpecError(
            f"optimizer {type(opt).__name__} (name={opt.name!r}) is not "
            f"registered; register_optimizer() it first")
    params = {f.name: getattr(opt, f.name)
              for f in dataclasses.fields(opt) if f.name != "name"}
    return OptimizerSpec(name=opt.name, params=params)


def make_store(spec_store: str, array, shard_size: int, *,
               workdir: str | None = None, field: str = "data",
               delay_s: float = 0.0):
    """One field array -> a ShardStore per the DataSpec's storage knobs."""
    if spec_store == "memory":
        store = InMemoryShardStore(array, shard_size)
    elif spec_store == "memmap":
        if workdir is None:
            raise SpecError("store='memmap' needs DataSpec.workdir (the "
                            "shard directory)")
        store = MemmapShardStore.write(array, f"{workdir}/{field}",
                                       shard_size)
    else:
        STORES.get(spec_store)      # raises with the registered names
        raise SpecError(f"store {spec_store!r} is registered but not "
                        f"constructible from a DataSpec")
    if delay_s > 0:
        store = ThrottledStore(store, delay_s)
    return store
