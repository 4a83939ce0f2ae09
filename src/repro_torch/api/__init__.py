# The declarative front door of the port: the reference's RunSpec schema
# (specs.py, a copy), build(spec, device=...) -> Session for the branches
# this port carries (one host or N, elastic or not),
# resume_session(directory, device=...) for their stage checkpoints and
# run(workload, device=...) for a workload preset's name; the others raise
# SpecError naming the slice that brings them.
from .specs import (CheckpointSpec, DataSpec, ElasticSpec, ModelSpec,
                    ObsSpec, OptimizerSpec, PolicySpec, RunSpec,
                    ScheduleSpec, ServeSpec, SpecError, TieringSpec,
                    TopologySpec)
from .registry import (OPTIMIZERS, POLICIES, STORES, TIERS, TOPOLOGIES,
                       WORKLOADS, build_optimizer, build_policy, make_store,
                       optimizer_spec_of, register_tier_manager,
                       register_workload)
from .session import (Session, build, check_resume_spec, convex_problem,
                      resume_session, run)

__all__ = [
    "RunSpec", "DataSpec", "PolicySpec", "OptimizerSpec", "ScheduleSpec",
    "TopologySpec", "ElasticSpec", "CheckpointSpec", "ServeSpec",
    "ObsSpec", "ModelSpec", "TieringSpec", "SpecError", "Session", "build",
    "run", "resume_session", "check_resume_spec", "convex_problem",
    "POLICIES", "OPTIMIZERS", "STORES", "TIERS", "TOPOLOGIES", "WORKLOADS",
    "build_policy", "build_optimizer", "make_store", "optimizer_spec_of",
    "register_tier_manager", "register_workload",
]
