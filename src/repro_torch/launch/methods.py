"""The paper's method set on the port: BET (two-track and fixed-steps),
Batch, BET with the gradient-variance trigger, DSM and mini-batch Adagrad,
each run over a convex fixture.

This is the port's own copy of what the method set needs from the
reference's ``benchmarks/common.py`` (``setup``, ``clock``,
``default_newton``, ``run_method``, ``time_to_rfvd``), with a ``device``
beside each entry point.  Run as a module, it runs the set on the
reference benchmarks' fixtures and prints one JSON line per (fixture,
method):

    python -m repro_torch.launch.methods [--device cpu]

The fixtures are those of the paper's Fig. 2 (w8a_like, rcv1_like and
realsim_like at scale 1, susy_like at 0.125), Fig. 3 (webspam_like at
0.5) and the Thm 4.1 access study (w8a_like at 0.25).  Each line holds
the simulated time and data accesses at the end of the run, its stages
and optimizer steps, the final f̂ and log-RFVD against a high-precision
minimizer, the wall seconds (ended by a synchronize on the card), the
launches of the ``linear_value_grad`` kernel (0 on the CPU, which runs
its plain version) and the calls of it the trace implies.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..api import (DataSpec, PolicySpec, RunSpec, ScheduleSpec, build,
                   convex_problem, optimizer_spec_of)
from ..core import SimulatedClock, run_dsm, run_minibatch
from ..kernels import ops
from ..models.linear import rfvd, solve_reference
from ..optim import Adagrad, NewtonCG

# (dataset, scale): Fig. 2's four, Fig. 3's and Thm 4.1's
FIXTURES = [("w8a_like", 1.0), ("rcv1_like", 1.0), ("realsim_like", 1.0),
            ("susy_like", 0.125), ("webspam_like", 0.5), ("w8a_like", 0.25)]
METHODS = ["bet_fixed", "bet", "batch", "bet_gradvar", "dsm", "adagrad"]


def setup(dataset: str, scale: float = 0.125, lam: float = 1e-3,
          loss: str = "squared_hinge", condition_boost: bool = False,
          generator: dict | None = None, ref_steps: int = 60, *,
          device="cuda"):
    """The convex fixture, built through the declarative API on
    ``device``: (Dataset, objective, w0, f*).  The Dataset carries its
    DataSpec (``ds.spec``), so ``run_method`` rebuilds the exact workload
    from the spec alone."""
    spec = DataSpec(dataset=dataset, scale=scale, lam=lam, loss=loss,
                    condition_boost=condition_boost,
                    generator=generator or ())
    ds, obj, w0 = convex_problem(spec, device=device)
    _, f_star = solve_reference(obj, w0, (ds.X, ds.y), steps=ref_steps)
    return ds, obj, w0, float(f_star)


def clock(**kw) -> SimulatedClock:
    """Paper defaults: p=10, a=1, s=5 (§5.1)."""
    base = dict(p=10.0, a=1.0, s=5.0)
    base.update(kw)
    return SimulatedClock(**base)


def default_newton(ds) -> NewtonCG:
    """The paper's R=0.1 assumes R·n >> d; at container-shrunk scales the
    fraction is raised so the sub-sampled Hessian stays full-rank."""
    frac = float(min(1.0, max(0.1, 2.0 * ds.d / ds.n)))
    return NewtonCG(hessian_fraction=frac)


def run_method(method: str, ds, obj, w0, *, clk=None, opt=None,
               theta: float = 0.2, n0: int | None = None, steps: int = 30,
               inner_steps: int = 5, final_steps: int = 25):
    """Run one named method over a ``setup()`` fixture, on the fixture's
    device.  The spec-built methods rebuild the objective and the zero
    start point from ``ds.spec``; a non-zero ``w0`` is rejected."""
    clk = clk if clk is not None else clock()
    opt = opt or default_newton(ds)
    if w0 is not None and bool(torch.any(w0 != 0)):
        raise ValueError(
            "run_method starts from init_params (zeros) via the RunSpec; "
            "custom starting points need repro_torch.api.build directly")
    if n0 is None:
        # an initial window large enough that the first-stage objective
        # is not rank-deficient
        n0 = max(128, min(ds.d, ds.n // 8))
    # non-BET baselines: dedicated drivers, not engine policies
    if method == "dsm":
        return run_dsm(ds, opt, obj, theta=theta, n0=n0, steps=steps,
                       clock=clk, w0=w0)
    if method == "adagrad":
        return run_minibatch(ds, Adagrad(lr=0.5), obj, batch_size=64,
                             steps=steps * 40, clock=clk, w0=w0,
                             record_every=20)
    policies = {
        "bet": PolicySpec("two_track", {"final_steps": final_steps}),
        "bet_fixed": PolicySpec("fixed_steps",
                                {"inner_steps": inner_steps,
                                 "final_steps": final_steps}),
        "batch": PolicySpec("batch", {"steps": steps}),
        "bet_gradvar": PolicySpec("gradient_variance",
                                  {"theta": theta,
                                   "final_steps": final_steps}),
    }
    if method not in policies:
        raise ValueError(method)
    if ds.spec is None:
        raise ValueError(
            "run_method rebuilds the workload from its DataSpec: build the "
            "fixture through setup / repro_torch.api.convex_problem")
    spec = RunSpec(data=DataSpec.from_dict(ds.spec),
                   policy=policies[method],
                   optimizer=optimizer_spec_of(opt),
                   schedule=ScheduleSpec(n0=n0, clock=clk.spec_params()))
    return build(spec, device=ds.X.device).run()


def time_to_rfvd(trace, f_star: float, tol: float) -> float:
    """Simulated time until (f - f*)/|f*| < tol; inf if never."""
    for p in trace.points:
        if (p.f_full - f_star) / abs(f_star) < tol:
            return p.time
    return float("inf")


def kernel_calls(trace) -> int:
    """The ``linear_value_grad`` calls a method's trace implies: one per
    optimizer step, two per race step, whose fast track steps too (the
    race stops at its trigger: no step runs past it)."""
    race = sum("f_fast_on_t" in p.extra for p in trace.points)
    return trace.final().step + 1 + race


def measure(method: str, ds, obj, w0, f_star: float, **kw) -> dict:
    """One ``run_method`` run, timed on the host clock (ended by a
    synchronize on the card), with its kernel launches, the kernel calls
    its trace implies, and its result."""
    card = ds.X.device.type == "cuda"
    before = ops.CALLS["linear_value_grad"]
    t0 = time.perf_counter()
    tr = run_method(method, ds, obj, w0, **kw)
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    last = tr.final()
    return {"method": method, "sim_time": last.time,
            "data_accesses": last.accesses,
            "stages": len(set(tr.column("stage"))), "steps": last.step + 1,
            "f_full": last.f_full,
            "log_rfvd": float(rfvd(obj, tr.params, (ds.X, ds.y), f_star)),
            "wall_s": wall,
            "linear_value_grad_launches":
                ops.CALLS["linear_value_grad"] - before,
            "kernel_calls_implied": kernel_calls(tr)}


def run_set(device="cuda"):
    """The method set on every fixture: one row (a dict) per (fixture,
    method), as ``measure`` gives it with the fixture's name and shape.
    The kernels' launch counts are set to 0 just before each run, so
    ``ops.CALLS`` holds that run's alone when its row is yielded."""
    for dataset, scale in FIXTURES:
        ds, obj, w0, f_star = setup(dataset, scale=scale, device=device)
        for method in METHODS:
            ops.reset_calls()
            row = measure(method, ds, obj, w0, f_star, final_steps=25,
                          steps=30)
            yield {"fixture": f"{dataset}@{scale}", "n": ds.n, "d": ds.d,
                   "device": str(ds.X.device), "f_star": f_star, **row}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    for row in run_set(ap.parse_args(argv).device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
