"""LM trainer — the port of ``repro.launch.train``: a thin
argparse -> RunSpec client.

All composition lives behind the declarative front door
(``repro_torch.api.build(RunSpec, device=...) -> Session``): this module
only translates CLI flags (or the library-facing :class:`TrainConfig`)
into a :class:`~repro_torch.api.RunSpec` and drives the session.

Schedules map to policies: ``batch`` → NeverExpand, ``bet`` → FixedSteps
(Alg. 1/3), ``two_track`` → TwoTrack (Alg. 2).  Runs go to the card
unless ``--device cpu`` (``device="cpu"``) asks for the CPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --schedule two_track --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --workload \\
        granite-moe@2stages --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --dry-run --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from .. import configs
from ..api import (CheckpointSpec, DataSpec, ElasticSpec, ModelSpec,
                   OptimizerSpec, PolicySpec, RunSpec, ScheduleSpec,
                   TopologySpec, build)
from ..core.trace import Trace


@dataclasses.dataclass
class TrainConfig:
    """Library-facing knobs for the LM path — a flat, keyword-friendly
    mirror of the RunSpec fields the CLI exposes (``to_run_spec`` is the
    one translation)."""
    schedule: str = "bet"           # batch | bet | two_track
    batch_size: int = 8
    seq_len: int = 128
    n0: int = 64                    # initial window (sequences)
    corpus_size: int = 1024
    inner_steps: int = 8            # steps per stage (bet)
    final_steps: int = 16
    lr: float = 1e-3
    seed: int = 0
    max_stage_steps: int = 200      # two-track safety bound
    eval_rows: int = 64             # probe size for condition (3) / eval loss
    use_plane: bool = True          # streaming data plane vs host-slice path
    # corpus shard granularity (plane only); with num_hosts > 1 it is
    # clamped to n0 // num_hosts so every host owns a shard from stage 0
    shard_size: int = 64
    prefetch_workers: int = 1   # one sequential load channel (§4.2's ``a``)
    # > 1: simulated multi-host data parallelism (dist/) — per-host batch
    # composition, so the trajectory intentionally differs from single host
    num_hosts: int = 1
    # fault tolerance (elastic/): stage checkpoints land in ckpt_dir; resume
    # restarts from the latest one; kill_host_at="STAGE:HOST" injects a host
    # loss at that stage boundary (hosts > 1)
    ckpt_dir: str | None = None
    resume: bool = False
    kill_host_at: str | None = None
    straggler_deadline_s: float | None = None


_POLICIES = {
    "batch": lambda tc: PolicySpec("batch", {"steps": tc.final_steps,
                                             "eval_full": True}),
    "bet": lambda tc: PolicySpec("fixed_steps",
                                 {"inner_steps": tc.inner_steps,
                                  "final_steps": tc.final_steps}),
    "two_track": lambda tc: PolicySpec(
        "two_track", {"final_steps": tc.final_steps,
                      "max_stage_iters": tc.max_stage_steps,
                      "condition": "eval", "final_eval_full": True}),
}


def to_run_spec(cfg, tc: TrainConfig, *,
                clock: dict | None = None) -> RunSpec:
    """TrainConfig -> the declarative RunSpec the session is built from.

    ``cfg`` may be a ModelConfig (its name resolves through the configs
    registry; the full vs ``configs.reduced`` variant is detected) or a
    bare arch name, which builds the **reduced** smoke variant.  Other
    changes to a config go into the returned spec's
    ``ModelSpec.overrides``.  ``clock`` overrides the §4.2 time-model
    parameters (default: data preloaded up to n0)."""
    if isinstance(cfg, str):
        arch, reduced = cfg, True
    else:
        # a reduced() config keeps its registry name; rebuild the same way
        arch = cfg.name
        full = configs.get(arch)
        if cfg == full:
            reduced = False
        elif cfg == configs.reduced(full):
            reduced = True
        else:
            raise ValueError(
                f"train.py rebuilds {arch!r} from the configs registry; "
                f"express custom configs as ModelSpec.overrides through "
                f"repro_torch.api.build directly")
    if tc.schedule not in _POLICIES:
        raise ValueError(f"unknown schedule {tc.schedule!r}; "
                         f"pick from {sorted(_POLICIES)}")
    faults = (f"kill@{tc.kill_host_at}",) if tc.kill_host_at else ()
    return RunSpec(
        name=f"lm_{tc.schedule}",
        data=DataSpec(kind="lm", corpus_size=tc.corpus_size,
                      seq_len=tc.seq_len, eval_rows=tc.eval_rows,
                      plane="plane" if tc.use_plane else "host",
                      shard_size=tc.shard_size,
                      prefetch_workers=tc.prefetch_workers, seed=tc.seed),
        model=ModelSpec(arch=arch, reduced=reduced),
        policy=_POLICIES[tc.schedule](tc),
        optimizer=OptimizerSpec("adamw_lm", {"lr": tc.lr,
                                             "batch_size": tc.batch_size}),
        schedule=ScheduleSpec(n0=tc.n0,
                              clock=clock if clock is not None
                              else {"preloaded": tc.n0},
                              step_cost="batch", wait_on_expand=True,
                              carry_state=True),
        topology=TopologySpec(hosts=tc.num_hosts),
        elastic=ElasticSpec(
            faults=faults,
            straggler_deadline_s=tc.straggler_deadline_s,
            capacity_slack=2.0 if tc.straggler_deadline_s else 1.0),
        checkpoint=CheckpointSpec(directory=tc.ckpt_dir, resume=tc.resume),
    )


def train_lm(cfg, tc: TrainConfig, *, device="cuda", clock=None,
             progress=None) -> Trace:
    """Run the LM path the TrainConfig describes on ``device`` through
    the one composition path (``repro_torch.api.build``).  ``cfg`` must
    be a registered architecture's ModelConfig (possibly
    ``configs.reduced``); ``clock`` accepts a fresh SimulatedClock whose
    parameters are folded into the spec."""
    clock_dict = clock.spec_params() if clock is not None else None
    return build(to_run_spec(cfg, tc, clock=clock_dict),
                 device=device).run(progress=progress)


def _run_workload(name: str, *, device: str, dry_run: bool) -> None:
    from ..api import run as run_workload
    from ..workloads import get_workload
    spec = get_workload(name).spec()
    if dry_run:
        print(spec.to_json())
        # build refuses a serve spec, naming serve.build_loop, as the
        # reference's does
        with build(spec, device=device) as session:
            for info in session.stage_plan():
                print(f"stage {info.stage}: window {info.n_t}"
                      f"{' (final)' if info.is_final else ''}")
        return
    t0 = time.time()
    trace = run_workload(name, device=device).trace
    print(f"workload {name!r} done in {time.time()-t0:.1f}s wall; "
          f"{trace.meta.get('stages')} stages, "
          f"{trace.meta.get('host_transfers')} host transfers")


def _list_workloads() -> None:
    from ..workloads import PRESETS, describe
    width = max(len(p.name) for p in PRESETS)
    for p in PRESETS:
        print(f"{p.name:<{width}}  {describe(p.name)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", type=str, default=None, metavar="NAME",
                    help="run a workload preset ('arch@scenario', see "
                         "--list-workloads) instead of composing a run "
                         "from the per-component flags below; mutually "
                         "exclusive with them")
    ap.add_argument("--list-workloads", action="store_true",
                    help="print the workload matrix (name + one-line "
                         "scenario description) and exit")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    ap.add_argument("--arch", type=str, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--schedule", type=str, default="bet",
                    choices=["batch", "bet", "two_track"])
    ap.add_argument("--inner-steps", type=int, default=8)
    ap.add_argument("--final-steps", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n0", type=int, default=64)
    ap.add_argument("--corpus", type=int, default=1024)
    ap.add_argument("--hosts", type=int, default=1,
                    help="simulated multi-host data parallelism (dist/)")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="save a full-runtime stage checkpoint at every "
                         "stage boundary (elastic/checkpoint.py)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest stage checkpoint from "
                         "--ckpt-dir and continue the schedule from there")
    ap.add_argument("--kill-host-at", type=str, default=None,
                    metavar="STAGE:HOST",
                    help="inject a host loss at a stage boundary (needs "
                         "--hosts > 1)")
    ap.add_argument("--straggler-deadline", type=float, default=None,
                    metavar="SECONDS",
                    help="deadline-based stage flush: migrate a straggler "
                         "host's next-expansion shards when its backlog "
                         "will not drain in time")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the composed RunSpec (JSON) and the stage "
                         "plan, then exit without running")
    args = ap.parse_args(argv)

    if args.list_workloads:
        _list_workloads()
        return
    if args.workload is not None:
        # --workload IS the run description: per-component flags would
        # silently fight the preset, so their non-default use is an error
        component_flags = {
            "--arch": args.arch != "qwen3-0.6b",
            "--schedule": args.schedule != "bet",
            "--inner-steps": args.inner_steps != 8,
            "--final-steps": args.final_steps != 16,
            "--batch-size": args.batch_size != 8,
            "--seq-len": args.seq_len != 128,
            "--n0": args.n0 != 64,
            "--corpus": args.corpus != 1024,
            "--hosts": args.hosts != 1,
            "--ckpt-dir": args.ckpt_dir is not None,
            "--resume": args.resume,
            "--kill-host-at": args.kill_host_at is not None,
            "--straggler-deadline": args.straggler_deadline is not None,
        }
        used = sorted(k for k, v in component_flags.items() if v)
        if used:
            ap.error(f"--workload composes the whole run; drop {used} "
                     f"(scenario tokens cover them)")
        _run_workload(args.workload, device=args.device,
                      dry_run=args.dry_run)
        return

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    tc = TrainConfig(schedule=args.schedule, inner_steps=args.inner_steps,
                     final_steps=args.final_steps, batch_size=args.batch_size,
                     seq_len=args.seq_len, n0=args.n0, corpus_size=args.corpus,
                     num_hosts=args.hosts, ckpt_dir=args.ckpt_dir,
                     resume=args.resume, kill_host_at=args.kill_host_at,
                     straggler_deadline_s=args.straggler_deadline)
    session = build(to_run_spec(cfg, tc), device=args.device)
    if args.dry_run:
        print(session.spec.to_json())
        for info in session.stage_plan():
            print(f"stage {info.stage}: window {info.n_t}"
                  f"{' (final)' if info.is_final else ''}")
        session.close()
        return
    t0 = time.time()
    trace = session.run(progress=lambda p: print(
        f"step {p.step:4d} stage {p.stage} window {p.window:5d} "
        f"t={p.time:9.0f} loss={p.f_window:.4f} eval={p.f_full:.4f}",
        flush=True))
    if trace.points:
        p = trace.final()
        print(f"done in {time.time()-t0:.1f}s wall; simulated time "
              f"{p.time:.0f}, accesses {p.accesses}, "
              f"final eval loss {p.f_full:.4f}")
    else:
        print(f"done in {time.time()-t0:.1f}s wall; the checkpoint is "
              f"already at the end of the schedule — nothing left to run")
    dp = trace.meta.get("data_plane")
    if dp:
        print(f"data plane: loaded {dp['examples_loaded']} examples "
              f"({dp['bytes_loaded']} B) once, reuse x{dp['reuse_ratio']}, "
              f"load/compute overlap {dp['overlap_fraction']:.2f}")
    rw = trace.meta.get("resume_rewarm")
    if rw:
        print(f"resumed from stage checkpoint: re-warmed "
              f"{rw['examples_loaded']} resident examples "
              f"({rw['bytes_loaded']} B) outside the Thm 4.1 counters")
    for group in trace.meta.get("elastic_events", []):
        for ev in group["events"]:
            print(f"elastic @stage {group['stage']}: {ev}")


if __name__ == "__main__":
    main()
