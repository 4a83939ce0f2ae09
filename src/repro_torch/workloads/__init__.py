# The workloads subsystem, the port of repro.workloads: one string names a
# full run over the model zoo.  Family adapters generalize the LM path to
# every family (the scan kernels carry the mamba and rglru traffic), and
# the preset grammar composes scenarios (stages/hosts/elastic/stream/
# serve/obs) into RunSpecs; the sweep runs the matrix and proves each
# preset's claims from its telemetry.
from .families import FAMILIES, LMFamily, family_of_config, resolve_family
from .presets import (PRESETS, SHORT, WorkloadPreset, describe,
                      get_workload, parse, workload_spec)
from .sweep import SweepResult, run_preset, sweep

__all__ = [
    "FAMILIES", "LMFamily", "family_of_config", "resolve_family",
    "PRESETS", "SHORT", "WorkloadPreset", "describe", "get_workload",
    "parse", "workload_spec", "SweepResult", "run_preset", "sweep",
]
