"""End-to-end driver: BET as a data schedule for LM pre-training — the
port of ``examples/bet_lm_training.py``, printing the same lines.

Trains a reduced assigned architecture with the expanding-window
pipeline, comparing the three schedules.  Each run is one declarative
``RunSpec``: the schedule comparison is a one-field sweep over
``PolicySpec``s (``launch/train.py`` is the CLI form of the same spec).

    python -m repro_torch.examples.bet_lm_training [--arch qwen3-0.6b]
        [--steps-per-stage 8] [--full-size] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..api import (DataSpec, ModelSpec, OptimizerSpec, PolicySpec, RunSpec,
                   ScheduleSpec, build)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps-per-stage", type=int, default=6)
    ap.add_argument("--final-steps", type=int, default=24)
    ap.add_argument("--corpus", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--full-size", action="store_true",
                    help="use a ~100M-param variant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M-param member of the same family — plain ModelConfig field
    # overrides; the vocabulary is only ever capped, never enlarged
    if args.full_size:
        from .. import configs
        vocab = min(configs.get(args.arch).vocab_size, 32768)
        overrides = dict(num_layers=8, d_model=768, num_heads=12,
                         num_kv_heads=4, head_dim=64, d_ff=2048,
                         vocab_size=vocab)
    else:
        overrides = {}
    model = ModelSpec(arch=args.arch, reduced=not args.full_size,
                      overrides=overrides)

    policies = {
        "bet": PolicySpec("fixed_steps", {"inner_steps": args.steps_per_stage,
                                          "final_steps": args.final_steps}),
        "two_track": PolicySpec("two_track", {"final_steps": args.final_steps,
                                              "condition": "eval",
                                              "final_eval_full": True,
                                              "max_stage_iters": 200}),
        "batch": PolicySpec("batch", {"steps": args.final_steps,
                                      "eval_full": True}),
    }

    results = {}
    for schedule, policy in policies.items():
        session = build(RunSpec(
            name=f"lm_{schedule}",
            data=DataSpec(kind="lm", corpus_size=args.corpus,
                          seq_len=args.seq_len, plane="plane"),
            model=model,
            policy=policy,
            optimizer=OptimizerSpec("adamw_lm", {"lr": 1e-3,
                                                 "batch_size":
                                                 args.batch_size}),
            schedule=ScheduleSpec(n0=64, step_cost="batch",
                                  wait_on_expand=True, carry_state=True,
                                  clock={"p": 10.0, "a": 2.0, "s": 5.0,
                                         "preloaded": 64}),
        ), device=args.device)
        if schedule == "bet":
            cfg = session.model_config
            print(f"arch={cfg.name} params≈{cfg.total_params()/1e6:.1f}M "
                  f"(active {cfg.active_params()/1e6:.1f}M)")
        tr = session.run()
        results[schedule] = tr
        p = tr.final()
        dp = tr.meta.get("data_plane", {})
        print(f"{schedule:10s} steps={p.step+1:4d} sim_time={p.time:9.0f} "
              f"final_eval_loss={p.f_full:.4f} "
              f"loaded={dp.get('examples_loaded', '-')} "
              f"overlap={dp.get('overlap_fraction', '-')}")

    # BET's systems win: eval loss at the moment Batch can take its FIRST
    # step
    t0 = results["batch"].points[0].time
    for schedule in ("bet", "two_track"):
        pts = [p.f_full for p in results[schedule].points if p.time <= t0]
        if pts:
            print(f"while Batch waited for data (t<={t0:.0f}), {schedule} "
                  f"already reached eval loss {min(pts):.4f}")
    return results


if __name__ == "__main__":
    main()
