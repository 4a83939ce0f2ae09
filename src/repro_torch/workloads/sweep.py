"""Spec-grid sweep driver — smoke-run the workload matrix and prove it;
the port of ``repro.workloads.sweep``.

``run_preset`` executes one preset end to end (offline presets through
``build(spec) → Session.run()``, serve presets through
``repro_torch.serve.build_loop``) on ``device`` with the telemetry plane
forced on, and
returns a :class:`SweepResult` whose ``claims`` dict is the per-preset
evidence the benchmark asserts:

- ``builds`` / ``trained_ge_2_stages`` — the spec composed and the engine
  ran at least two expansion stages;
- ``le_one_transfer_per_stage`` — from ``trace.meta`` (the engine's own
  transfer counter);
- ``kernel_routed`` — for kernel-backed families (mamba/rglru), every
  kernel the family declares was launched on the card (``ops.CALLS``),
  i.e. the training traffic really went through the hand-written
  kernels; on the CPU, where nothing launches, that every such kernel's
  wrapper was called (``ops.ROUTED``, the reference's own count of
  dispatches);
- ``loss_finite`` — the trained objective stayed finite (the custom-vjp
  backward is doing its job);
- plane-backed presets additionally reuse the obs
  :class:`~repro_torch.obs.report.RunReport` claims (``zero_resident_reupload``,
  ``each_example_loaded_once``; ``overlap_ge_half`` for ``stream``
  scenarios, where the throttle makes overlap the point).

Every preset runs in its own subdirectory of ``workdir`` (checkpoints,
event logs, reports), so a sweep leaves a full per-preset obs artifact
trail for CI to validate and upload.
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
import time

from ..api.session import build
from ..api.specs import RunSpec
from ..device import resolve_device
from ..kernels import ops
from .families import FAMILIES
from .presets import PRESETS, get_workload


@dataclasses.dataclass
class SweepResult:
    name: str
    arch: str
    family: str
    scenario: str
    claims: dict
    stages: int = 0
    transfers: int = 0
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    final_loss: float | None = None
    wall_s: float = 0.0
    obs_dir: str | None = None
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None and all(self.claims.values())

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _prepare(spec: RunSpec, root: pathlib.Path) -> RunSpec:
    """Point the spec's filesystem knobs into the sweep workdir and force
    the telemetry plane on (the claims are recomputed from its events)."""
    obs_dir = root / "obs"
    spec = spec.replace(obs=spec.obs.replace(
        enabled=True, dir=str(obs_dir), report=True))
    if spec.checkpoint.directory or spec.serve.enabled:
        spec = spec.replace(checkpoint=spec.checkpoint.replace(
            directory=str(root / "ckpt")))
    if spec.data.workdir:
        spec = spec.replace(data=spec.data.replace(
            workdir=str(root / "shards")))
    return spec


def _final_loss(trace) -> float | None:
    points = getattr(trace, "points", None) or []
    for p in reversed(points):
        for attr in ("f_full", "f_window"):
            v = getattr(p, attr, None)
            if v is not None:
                return float(v)
    return None


def run_preset(name: str, workdir, *, device="cuda") -> SweepResult:
    """One matrix cell on ``device``, end to end, with the evidence
    attached."""
    dev = resolve_device(device)
    preset = get_workload(name)
    fam = FAMILIES[preset.family]
    root = pathlib.Path(workdir) / name.replace("@", "_")
    root.mkdir(parents=True, exist_ok=True)
    res = SweepResult(name=name, arch=preset.arch, family=preset.family,
                      scenario=preset.scenario, claims={})
    t0 = time.perf_counter()
    ops.reset_calls()
    try:
        spec = _prepare(preset.spec(), root)
        loop_report = None
        if spec.serve.enabled:
            from ..serve import build_loop
            loop = build_loop(spec, device=dev)
            loop_report = loop.run()
            trace, report = loop.trace, loop.run_report
        else:
            session = build(spec, device=dev)
            trace = session.run()
            report = session.run_report()
    except Exception as e:                      # noqa: BLE001 — the sweep
        res.error = f"{type(e).__name__}: {e}"  # reports, it doesn't raise
        res.claims = {"builds": False}
        res.wall_s = time.perf_counter() - t0
        return res
    res.wall_s = time.perf_counter() - t0
    res.kernel_calls = dict(ops.CALLS)
    res.stages = int(trace.meta.get("stages", 0))
    res.transfers = int(trace.meta.get("host_transfers", 0))
    res.final_loss = _final_loss(trace)
    res.obs_dir = spec.obs.dir

    # a traffic-driven stage legitimately flushes once per held chunk
    # (training continues while arrivals lag), so the serve budget is
    # stages + holds — the same accounting bench_serve uses
    transfer_budget = res.stages + \
        int((loop_report or {}).get("holds", 0))
    claims = {
        "builds": True,
        "trained_ge_2_stages": res.stages >= 2,
        "le_one_transfer_per_stage": res.transfers <= transfer_budget,
        "loss_finite": res.final_loss is not None
        and math.isfinite(res.final_loss),
    }
    if fam.kernels:
        routed = res.kernel_calls if dev.type == "cuda" else ops.ROUTED
        claims["kernel_routed"] = all(
            routed.get(k, 0) > 0 for k in fam.kernels)
    rr = report.claims() if report is not None else {}
    tokens = preset.scenario.split("-")
    if spec.data.plane == "plane":
        if rr.get("zero_resident_reupload") is not None:
            claims["zero_resident_reupload"] = rr["zero_resident_reupload"]
        # host-loss recovery legitimately re-reads the lost lane's slice,
        # and the serve corpus is open-ended — only the plain plane
        # scenarios can claim exactly-once loads
        if "elastic" not in tokens and not spec.serve.enabled \
                and rr.get("each_example_loaded_once") is not None:
            claims["each_example_loaded_once"] = \
                rr["each_example_loaded_once"]
        if "stream" in tokens:
            claims["overlap_ge_half"] = rr["overlap_ge_half"]
    res.claims = claims
    return res


def sweep(names=None, workdir=".workloads_sweep", *, device="cuda",
          progress=None) -> list[SweepResult]:
    """Run the matrix (default: every registered preset) on ``device`` and
    return the per-preset results; ``progress(result)`` fires after each
    cell."""
    out = []
    for name in names or [p.name for p in PRESETS]:
        res = run_preset(name, workdir, device=device)
        out.append(res)
        if progress is not None:
            progress(res)
    return out
