"""Named registries — every ported policy and optimizer is addressable
from a spec by name.

A name the reference registers but this port does not carry yet raises a
:class:`SpecError` that says so and names the slice that brings it,
instead of an unknown-name error.
"""
from __future__ import annotations

import difflib
from typing import Any

from ..core.engine import (ComposedPolicy, ExpansionPolicy, FixedSteps,
                           NeverExpand, TwoTrack)
from ..optim import REGISTRY as _OPTIM_REGISTRY
from ..optim.api import BatchOptimizer
from .specs import OptimizerSpec, PolicySpec, SpecError


class Registry:
    """A name -> factory table with actionable lookup errors.  ``pending``
    maps reference names not yet ported to the slice that brings them."""

    def __init__(self, kind: str, entries: dict[str, Any] | None = None,
                 pending: dict[str, str] | None = None):
        self.kind = kind
        self._entries: dict[str, Any] = dict(entries or {})
        self.pending: dict[str, str] = dict(pending or {})

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            if name in self.pending:
                raise SpecError(
                    f"{self.kind} {name!r} is not yet ported to repro_torch "
                    f"(it comes with {self.pending[name]}); ported: "
                    f"{sorted(self._entries)}") from None
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
}, pending={
    "bet_gradvar": "the GradientVariance policy (ROADMAP queue A4)",
    "gradient_variance": "the GradientVariance policy (ROADMAP queue A4)",
    "traffic_driven": "the serve slice (ROADMAP queue A11)",
})

# --------------------------------------------------------------- optimizers
OPTIMIZERS = Registry("optimizer", dict(_OPTIM_REGISTRY), pending={
    "cg": "the remaining optimizers (ROADMAP queue A3)",
    "lbfgs": "the remaining optimizers (ROADMAP queue A3)",
    "adagrad": "the remaining optimizers (ROADMAP queue A3)",
    "adamw": "the remaining optimizers (ROADMAP queue A3)",
    "adamw_lm": "the LM slice (ROADMAP queue A9)",
})


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
    try:
        return cls(**spec.params)
    except TypeError as e:
        raise SpecError(f"optimizer {spec.name!r}: {e}") from None

