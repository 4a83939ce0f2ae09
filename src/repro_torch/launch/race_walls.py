#!/usr/bin/env python3
"""Wall seconds of the convex quickstart two-track run on the card, for
one checkout of the port:

    python3 src/repro_torch/launch/race_walls.py TREE [--runs 10]

TREE is a checkout's root; ``repro_torch`` is imported from TREE/src, so
one process times one checkout, and timing two checkouts in turn on one
card (parent, change, change, parent) compares them.  The spec is
``chip_smoke.py``'s quickstart@6 two-track (w8a_like at scale 6,
Newton-CG, ``final_steps=20``).  One untimed run builds the kernels and
warms up; then ``runs`` fresh sessions run, each timed on the host clock
and ended by ``torch.cuda.synchronize()``.  Prints one JSON line: the
tree, the warm-up and the walls in seconds, ``host_transfers``, the
steps and the final f̂ (equal across checkouts when the change keeps
the trace)."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    sys.path[0] = str(args.tree.resolve() / "src")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("race_walls: no CUDA device")
    from repro_torch import api

    spec = api.RunSpec(
        data=api.DataSpec(dataset="w8a_like", scale=6.0, lam=1e-3),
        optimizer=api.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=api.ScheduleSpec(n0=128, clock={"p": 10.0, "a": 1.0,
                                                 "s": 5.0}),
        policy=api.PolicySpec("two_track", {"final_steps": 20}))

    def timed():
        sess = api.build(spec, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = sess.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, tr

    warmup, _ = timed()
    walls = []
    for _ in range(args.runs):
        wall, tr = timed()
        walls.append(wall)
    print(json.dumps({"tree": str(args.tree), "warmup_s": warmup,
                      "walls_s": walls,
                      "transfers": tr.meta["host_transfers"],
                      "steps": len(tr.points),
                      "f_full": tr.final().f_full}), flush=True)


if __name__ == "__main__":
    main()
