"""The Two-Track controller (Algorithm 2) under the microscope: prints the
per-stage race between the slow (n_t) and fast (n_{t-1}) tracks and the
trigger points of condition (3); the port of ``examples/two_track_demo.py``,
printing the same lines.

The whole stack is one declarative spec (``repro_torch.api.RunSpec``); the
race runs on the device in chunks of doubling length, and the per-step
values printed here arrived on the host with ⌈log₂ s⌉ transfers per
racing stage of s steps.

    python -m repro_torch.examples.two_track_demo [--device cpu]
"""
from __future__ import annotations

import argparse

from ..api import (DataSpec, OptimizerSpec, PolicySpec, RunSpec,
                   ScheduleSpec, build)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    session = build(RunSpec(
        data=DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3),
        policy=PolicySpec("two_track", {"final_steps": 10}),
        optimizer=OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=ScheduleSpec(n0=128),
    ), device=device)
    tr = session.run()
    N = session.dataset.n

    last_stage = None
    for p in tr.points:
        if p.stage != last_stage:
            print(f"--- stage {p.stage}: window {p.window} "
                  f"({100.0 * p.window / N:.0f}% of data) ---")
            last_stage = p.stage
        fast = p.extra.get("f_fast_on_t")
        fast_s = f" fast={fast:.5f}" if fast is not None else " (final phase)"
        print(f"  t={p.time:8.0f}  slow={p.f_window:.5f}{fast_s}")
    print(f"\nexpansions are parameter-free: no kappa, no theta, no schedule "
          f"tuning; final f={tr.final().f_window:.5f} "
          f"({tr.meta['stages']} stages, {tr.meta['host_transfers']} host "
          f"transfers)")


if __name__ == "__main__":
    main()
