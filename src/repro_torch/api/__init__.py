# The declarative front door of the port: the reference's RunSpec schema
# (specs.py, a copy) and build(spec, device=...) -> Session for the
# branches this port carries; the others raise SpecError naming the slice
# that brings them.
from .specs import (CheckpointSpec, DataSpec, ElasticSpec, ModelSpec,
                    ObsSpec, OptimizerSpec, PolicySpec, RunSpec,
                    ScheduleSpec, ServeSpec, SpecError, TieringSpec,
                    TopologySpec)
from .registry import (OPTIMIZERS, POLICIES, build_optimizer, build_policy,
                       optimizer_spec_of)
from .session import Session, build, convex_problem

__all__ = [
    "RunSpec", "DataSpec", "PolicySpec", "OptimizerSpec", "ScheduleSpec",
    "TopologySpec", "ElasticSpec", "CheckpointSpec", "ServeSpec",
    "ObsSpec", "ModelSpec", "TieringSpec", "SpecError", "Session", "build",
    "convex_problem", "POLICIES", "OPTIMIZERS", "build_policy",
    "build_optimizer", "optimizer_spec_of",
]
