"""The convex path: whole BET solves of Eq. 1 through ``Session.run``.

Set-up makes (X, y) on the card from the seed (``yardstick/data.py``)
and runs one solve, which builds B1 and warms every window shape of the
cell's schedule.  The window then runs solves back to back, each a fresh
``Session`` over the resident data, composed as
``repro_torch.api.session._build_convex`` composes it (``Dataset``,
``LinearObjective``, the registry's optimizer and policy, ``BetEngine``,
the §4.2 clock), from w = 0 to the end of its policy's schedule, its
final iterate synchronised.  ``solve_s`` is the window's whole time over
the solves it completed.

Each solve's answer is its final iterate.  Once the window has closed,
every one is checked against ``reference/convex.py`` in float64: B1's
gradient there (the program's own entry, at the timed size) and the
suboptimality against the reference's minimum, which the configuration
bounds; and Newton-CG's Hessian-vector product where every solve's first
step takes it.
"""
from __future__ import annotations

import time

from perfbench.reference import convex as ref
from perfbench.yardstick import bounds, data, devtrace


def _stages(trace) -> list:
    """[(window, steps)] of a solve's stages, from its trace.  The path
    counts scan stages only: a racing stage (its points carry the fast
    track's f̂) has work of its own, which a cell that races counts."""
    out: dict = {}
    for p in trace.points:
        if "f_fast_on_t" in p.extra:
            raise ValueError("a racing stage: convex_solve counts the "
                             "work of scan stages only")
        window, steps = out.get(p.stage, (p.window, 0))
        out[p.stage] = (window, steps + 1)
    return list(out.values())


def plan(stages: list, d: int, opt: dict) -> tuple:
    """(B1's launch sizes in launch order, the solve's model FLOPs): one
    launch and one Newton-CG step a step, on its stage's window."""
    frac = float(opt.get("hessian_fraction", 0.1))
    cg = int(opt.get("cg_steps", 10))
    ls = int(opt.get("max_ls_steps", 30))
    launches, flops = [], 0.0
    for n, steps in stages:
        launches += [n] * steps
        flops += steps * bounds.newton_cg_step_flops(
            n, d, hessian_fraction=frac, cg_steps=cg, ls_candidates=ls)
    return launches, flops


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.api import (OptimizerSpec, PolicySpec, RunSpec,
                                 ScheduleSpec, Session, build_optimizer,
                                 build_policy)
    from repro_torch.core.engine import BETSchedule, BetEngine
    from repro_torch.core.timemodel import SimulatedClock
    from repro_torch.data.synthetic import Dataset
    from repro_torch.models.linear import init_params, make_objective

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    X, y = data.classification(cfg, ctx.seed, dev)
    d = X.shape[1]
    lam, loss = float(cfg["lam"]), cfg["loss"]
    ds = Dataset(cfg["name"], X, y, X[:1], y[:1])
    spec = RunSpec(name=tr["name"],
                   policy=PolicySpec(tr["policy"], tr["policy_params"]),
                   optimizer=OptimizerSpec(tr["optimizer"],
                                           tr["optimizer_params"]),
                   schedule=ScheduleSpec(n0=tr["n0"], growth=tr["growth"],
                                         clock=tr["clock"]))

    # tracks api/session._build_convex's composition, over the resident data
    def solve() -> dict:
        t0 = time.perf_counter()
        optimizer = build_optimizer(spec.optimizer)
        engine = BetEngine(
            schedule=BETSchedule(n0=spec.schedule.n0,
                                 growth=spec.schedule.growth),
            wait_on_expand=spec.schedule.wait_on_expand,
            carry_state=spec.schedule.carry_state)
        session = Session(spec, dataset=ds, optimizer=optimizer,
                          objective=make_objective(loss, lam=lam),
                          policy=build_policy(spec.policy), engine=engine,
                          clock=SimulatedClock(**spec.schedule.clock),
                          w0=init_params(d, device=dev), eval_data=(X, y),
                          problem=ds, device=dev)
        trace = session.run()
        w = trace.params
        sync()
        return {"w": w, "stages": _stages(trace),
                "s": time.perf_counter() - t0}

    solve()                                     # set-up: every shape
    sync()
    first, count = int(tr["trace_first_solve"]), int(tr["trace_solves"])
    span = devtrace.Span(torch) if ctx.trace else None
    solves = []
    t_w = time.perf_counter()
    setup_s = t_w - ctx.t0
    while True:
        if span is not None and len(solves) == first:
            span.open()
        if span is not None and first <= len(solves) < first + count:
            with span.marker("solve"):
                solves.append(solve())
        else:
            solves.append(solve())
        if span is not None and len(solves) == first + count:
            span.close()
        traced = span is None or len(solves) >= first + count
        if traced and time.perf_counter() - t_w >= ctx.seconds:
            break
    sync()
    window_s = time.perf_counter() - t_w
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    times = sorted(s["s"] for s in solves)
    ctx.log(f"{len(solves)} solves: {times[0]:.3f} s to {times[-1]:.3f} s, "
            f"median {times[len(times) // 2]:.3f} s; steps "
            f"{sorted(sum(st[1] for st in s['stages']) for s in solves)}")
    if span is not None:
        span.collect()

    # the shares over the window's untraced solves: the profiler slows
    # the traced ones
    opt = tr["optimizer_params"]
    flops, busy_s, launches = 0.0, 0.0, []
    for i, s in enumerate(solves):
        ls, fl = plan(s["stages"], d, opt)
        if first <= i < first + count and span is not None:
            launches.append(ls)
        else:
            flops += fl
            busy_s += s["s"]
    records = {"window_s": busy_s, "solves": len(solves),
               "model_flops": flops, "peak_flops": "float32",
               "b1_launches": launches, "d": d, "span": span}

    checks = check(ctx, X, y, [s["w"] for s in solves])
    return {"e2e": {"solve_s": window_s / len(solves), "setup_s": setup_s},
            "records": records, "checks": checks,
            "attempted": len(solves), "failed": 0,
            "memory_peak_bytes": peak}


def _finite(x: float) -> float:
    return x if x == x else float("inf")       # NaN reads as the worst


def check(ctx, X, y, ws: list, entries=None) -> list:
    """The comparison that decides ``correct``: each number the worst
    over the answers (the solves' final iterates ``ws``), beside its
    limit.  ``entries(w, k, v)`` gives the answerer's (gradient,
    Hessian-vector product on the first k rows) at w: by default the
    program's B1 and ``hvp_operator``; the control passes the
    reference's in TF32.  The product is taken where every solve's first
    Newton-CG step takes it, at w = 0 on rows 0..k: at a final iterate a
    row whose margin lies within rounding of 1 sets the squared hinge's
    curvature (a step) apart in float32 and float64, and one such row
    reads as a gap of ~3e-5 (PERF.md).  B1's value is not compared: in
    float32 and in TF32 the mean over the rows comes out alike, to some
    1e-7, and no limit tells the two apart; the gradient does."""
    torch = ctx.torch
    cfg, lim = ctx.config, ctx.limits
    lam = float(cfg["lam"])
    N, d = X.shape
    k = max(1, round(float(ctx.traffic["optimizer_params"]
                           .get("hessian_fraction", 0.1)) * N))
    v = torch.randn((d,), generator=data.generator(ctx.seed, X.device, 7),
                    dtype=torch.float32, device=X.device)
    if entries is None:
        from repro_torch.models.linear import make_objective
        objective = make_objective(cfg["loss"], lam=lam)

        def entries(w, k, v):
            _, g = objective.value_and_grad(w, (X, y))
            return g, objective.hvp_operator(w, (X[:k], y[:k]))(v)
    _, f_star = ref.solve(X, y, lam)
    w0 = torch.zeros((d,), dtype=torch.float32, device=X.device)
    hv_p = entries(w0, k, v)[1]
    hv_r = ref.hvp(X, y, w0, v, lam, k)
    worst = {"grad_rel": 0.0,
             "hvp_rel": _finite(float(torch.linalg.norm(hv_p.double() - hv_r)
                                      / torch.linalg.norm(hv_r))),
             "subopt": 0.0}
    for w in ws:
        g_p, _ = entries(w, k, v)
        f_r, g_r, s_r = ref.value_grad(X, y, w, lam)
        got = {"grad_rel": float(torch.linalg.norm(g_p.double() - g_r)
                                 / torch.linalg.norm(s_r)),
               "subopt": (float(f_r) - float(f_star)) / abs(float(f_star))}
        for key, val in got.items():
            worst[key] = max(worst[key], _finite(val))
    return [{"name": key, "value": val, "limit": float(lim[key])}
            for key, val in worst.items()]


def control(ctx, X, y) -> list:
    """The control: the reference in TF32 put in the program's place (its
    own solve, its own entries), judged by ``check``."""
    lam = float(ctx.config["lam"])
    w, _ = ref.solve(X, y, lam, prec="tf32")

    def entries(w, k, v):
        _, g, _ = ref.value_grad(X, y, w, lam, prec="tf32")
        return g, ref.hvp(X, y, w, v, lam, k, prec="tf32")
    return check(ctx, X, y, [w.float()], entries)
