#!/usr/bin/env python3
"""Wall seconds of the convex quickstart runs on the card, for one
checkout of the port:

    python3 src/repro_torch/launch/race_walls.py TREE [--runs 10]
        [--policy two_track batch] [--plane host plane]

TREE is a checkout's root; ``repro_torch`` is imported from TREE/src, so
one process times one checkout, and timing two checkouts in turn on one
card (parent, change, change, parent) compares them.  The spec is
``chip_smoke.py``'s quickstart@6 (w8a_like at scale 6, Newton-CG),
two-track (``final_steps=20``, the default) or batch (``steps=25``), on
the host path (the default) or the streaming plane (768 in-memory shards
of 64 rows).  For each policy and data path, one untimed run builds the
kernels and warms up; then ``runs`` fresh sessions run, each timed on the
host clock and ended by ``torch.cuda.synchronize()``.  Prints one JSON
line for each: the tree, the warm-up and the walls in seconds,
``host_transfers``, the steps, the final f̂ (equal across checkouts when
the change keeps the trace) and, on the plane, the last run's metered
load and blocked seconds.

With ``--lm ARCH`` it times that architecture's two-track LM run instead,
at full width as ``chip_smoke.py`` runs it (``launch/train.py``'s spec
on the streaming plane: 512 sequences, batch 8, n0 64, a probe of 16
rows, 16 steps a racing stage, 8 final steps, AdamW at lr 3e-4;
qwen3-0.6b at full depth on rows of 1,025 tokens, falcon-mamba-7b at 4
layers on rows of 257), one warm-up and ``runs`` timed runs; its line
adds the race graphs' capture seconds a round where the checkout records
them."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

POLICIES = {"two_track": {"final_steps": 20}, "batch": {"steps": 25}}
# --lm: (row length less one, layers; None keeps the config's)
LM_RUNS = {"qwen3-0.6b": (1024, None), "falcon-mamba-7b": (256, 4)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--policy", nargs="+", default=["two_track"],
                    choices=sorted(POLICIES))
    ap.add_argument("--plane", nargs="+", default=["host"],
                    choices=["host", "plane"])
    ap.add_argument("--lm", choices=sorted(LM_RUNS),
                    help="time this architecture's two-track LM run instead")
    args = ap.parse_args()
    sys.path[0] = str(args.tree.resolve() / "src")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("race_walls: no CUDA device")
    from repro_torch import api

    def timed(spec):
        sess = api.build(spec, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = sess.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, tr, sess

    if args.lm:
        lm_walls(args, torch, timed)
        return

    for policy in args.policy:
        for plane in args.plane:
            spec = api.RunSpec(
                data=api.DataSpec(dataset="w8a_like", scale=6.0, lam=1e-3,
                                  plane=plane),
                optimizer=api.OptimizerSpec("newton_cg",
                                            {"hessian_fraction": 0.2}),
                schedule=api.ScheduleSpec(n0=128, clock={"p": 10.0, "a": 1.0,
                                                         "s": 5.0}),
                policy=api.PolicySpec(policy, POLICIES[policy]))
            warmup, _, _ = timed(spec)
            walls = []
            for _ in range(args.runs):
                wall, tr, _ = timed(spec)
                walls.append(wall)
            meter = tr.meta.get("data_plane") or {}
            print(json.dumps({"tree": str(args.tree), "policy": policy,
                              "plane": plane, "warmup_s": warmup,
                              "walls_s": walls,
                              "transfers": tr.meta["host_transfers"],
                              "steps": len(tr.points),
                              "f_full": tr.final().f_full,
                              "load_time_s": meter.get("load_time_s"),
                              "blocked_time_s": meter.get("blocked_time_s")}),
                  flush=True)


def lm_walls(args, torch, timed) -> None:
    """The two-track LM run of ``--lm``: one warm-up, ``runs`` timed."""
    import gc
    from repro_torch import configs
    from repro_torch.launch import train
    seq_len, layers = LM_RUNS[args.lm]
    tc = train.TrainConfig(
        schedule="two_track", batch_size=8, seq_len=seq_len, n0=64,
        corpus_size=512, final_steps=8, lr=3e-4, max_stage_steps=16,
        eval_rows=16, use_plane=True)
    spec = train.to_run_spec(configs.get(args.lm), tc)
    if layers is not None:
        spec = spec.replace(model=spec.model.replace(
            overrides={"num_layers": layers}))
    walls, captures = [], []
    for i in range(args.runs + 1):
        torch.cuda.reset_peak_memory_stats()
        wall, tr, sess = timed(spec)
        walls.append(wall)
        captures.append(getattr(sess.engine, "race_capture_s", None))
        row = {"host_transfers": tr.meta["host_transfers"],
               "stages": tr.meta["stages"], "steps": len(tr.points),
               "f_full": tr.final().f_full,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del sess, tr
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(args.tree), "lm": args.lm,
                      "policy": "two_track", "warmup_s": walls[0],
                      "walls_s": walls[1:], "capture_s": captures, **row}),
          flush=True)


if __name__ == "__main__":
    main()
