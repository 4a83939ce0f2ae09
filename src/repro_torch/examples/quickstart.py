"""Quickstart: Batch-Expansion Training on a convex problem — the paper's
own setting (squared-hinge SVM, Eq. 1), through the port's declarative
front door; the port of ``examples/quickstart.py``, printing the same
lines.

One ``RunSpec`` describes a whole run (workload, policy, optimizer,
schedule + §4.2 time model); ``build(spec, device=...)`` composes and
validates the stack on the card (or the CPU, when asked), and
``Session.run()`` drives it.  Swapping the expansion policy is a one-line
spec change — ``two_track`` (Algorithm 2, parameter-free) vs the
``batch`` baseline below.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..api import (DataSpec, OptimizerSpec, PolicySpec, RunSpec,
                   ScheduleSpec, build, convex_problem)
from ..models.linear import accuracy, rfvd, solve_reference


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    # 1. The workload: a pre-permuted dataset (BET only ever reads prefix
    #    windows of it) + the Eq. 1 objective, and the paper's time model
    #    (compute accel p, load rate a, call overhead s).
    data = DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3)
    base = dict(
        data=data,
        # 2. An inner batch optimizer (paper §5 uses Sub-sampled Newton-CG).
        optimizer=OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=ScheduleSpec(n0=128, clock={"p": 10.0, "a": 1.0, "s": 5.0}),
    )

    # 3. Two specs, one engine: Two-Track BET (Algorithm 2) vs Batch.
    bet = build(RunSpec(policy=PolicySpec("two_track", {"final_steps": 20}),
                        **base), device=device)
    batch = build(RunSpec(policy=PolicySpec("batch", {"steps": 25}), **base),
                  device=device)
    tr_bet, tr_batch = bet.run(), batch.run()

    # 4. Report against the high-precision reference minimizer.
    ds, objective, w0 = convex_problem(data, device=device)
    _, f_star = solve_reference(objective, w0, (ds.X, ds.y), steps=60)
    for name, sess, tr in (("BET (two-track)", bet, tr_bet),
                           ("Batch", batch, tr_batch)):
        clk = sess.clock
        print(f"{name:16s} sim_time={clk.time:9.0f}  "
              f"data_accesses={clk.data_accesses:8d}  "
              f"log-RFVD={float(rfvd(objective, tr.params, (ds.X, ds.y), f_star)):6.2f}  "
              f"test_acc={float(accuracy(tr.params, ds.X_test, ds.y_test)):.4f}  "
              f"host_transfers={tr.meta['host_transfers']}")

    # 5. The headline: objective value when only 25% of the simulated time
    #    has passed.
    budget = 0.25 * batch.clock.time
    for name, tr in (("BET", tr_bet), ("Batch", tr_batch)):
        vals = [p.f_full for p in tr.points if p.time <= budget]
        print(f"at 25% budget: {name:6s} "
              f"f = {min(vals) if vals else float('inf'):.4f}")


if __name__ == "__main__":
    main()
