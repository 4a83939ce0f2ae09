#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100:
the kernels are built for sm_90a).  Phases, in order; any failure ends
the script with a non-zero exit and no result line:

 1. environment — the card's name and power limit (nvidia-smi), the torch
    and CUDA versions; TF32 off; every kernel built from the sources in
    the checkout (one nvcc per source, all started together).
 2. kernels — each kernel against its plain PyTorch version computed in
    float64 on the card, at the shapes the main path gives it, timed with
    CUDA events (the card's time, and the time per call with the host's
    share) beside its bound, its plain version and a library yardstick.
    One JSON line per shape.
 3. main path — ``repro_torch.api.build(spec, device="cuda").run()`` on
    the quickstart spec (examples/quickstart.py) at scale 6: two-track,
    then batch.  Launch counts are zeroed just before and read just after;
    every kernel of the path must have launched, and linear_value_grad
    exactly once per optimizer step the traces imply.
 4. card against CPU — the same workload under fixed_steps on the card
    and on the CPU (plain versions): clock and access columns equal,
    f̂ within rtol 1e-4.

Then the ``{"kernels": [...]}`` line, and last ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12

# Kernel check tolerance against the float64 plain version.  The kernel
# accumulates in float32: per-lane partials over a warp's rows, a fixed
# warp order within a block, then a fixed-order sum over at most
# 4 x SMs block partials.  Rounding grows like sqrt(terms) x 6e-8, i.e.
# ~1e-6 relative at n = 4M; 1e-5 on L and 1e-4 on g leave an order of
# magnitude of room and still catch a dropped row, a wrong loss branch or
# a racy reduction (all far above 1e-3).
RTOL_L = 1e-5
TOL_G = 1e-4
# card-vs-CPU main path: the same algorithm in float32 with different
# summation orders (cuBLAS and the kernel vs CPU BLAS); 1e-4 relative on
# f̂ after ~100 Newton-CG steps
RTOL_F = 1e-4

MAIN_SHAPE = (49152, 300)       # w8a_like at scale 6: the main path's full window
# (label, n, d, how the data is made)
KERNEL_SHAPES = [
    ("w8a_like@6", 49152, 300, ("load", "w8a_like", 6.0)),
    ("ragged", 49189, 300, ("randn",)),
    ("webspam_like@1", 16384, 1024, ("load", "webspam_like", 1.0)),
    ("rcv1_like@1", 4096, 2048, ("load", "rcv1_like", 1.0)),
    ("susy_like@64", 4194304, 18, ("load", "susy_like", 64.0)),
    ("small", 200, 32, ("randn",)),
]
LOSSES = ("squared_hinge", "logistic")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def spin_cycles_per_s(torch) -> float:
    """The rate of ``torch.cuda._sleep``'s spin loop, from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(cycles)           # warm-up
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / (start.elapsed_time(end) * 1e-3)


def time_ms(torch, fn, spin_rate: float, iters: int = 30) -> dict:
    """Mean time of ``fn`` over ``iters`` calls, after a warm-up, from CUDA
    events (L2 stays warm between calls, as it does for the engine's
    repeated calls on one window):

    - ``ms``: the card's time.  A spin kernel holds the stream while the
      host enqueues all calls, so the card then runs them back to back:
      no host gaps, only the work and the gaps between its own kernels.
    - ``call_ms``: calls issued back to back as a caller issues them; the
      larger of the host's time per call and the card's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    call_ms = start.elapsed_time(end) / iters
    spin_s = 2.0 * host_s + 0.005       # outlasts the enqueue with room
    torch.cuda._sleep(int(spin_rate * spin_s))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if enqueue_s >= spin_s:
        raise SystemExit(f"enqueue took {enqueue_s:.4f} s, longer than the "
                         f"{spin_s:.4f} s spin: the device time is not clean")
    return {"ms": start.elapsed_time(end) / iters, "call_ms": call_ms}


def bounds_ms(n: int, d: int) -> dict:
    """Least time for linear_value_grad's work: read X, y, w once, write g
    and L once; 4nd float32 operations (2nd forward, 2nd transposed)."""
    bytes_ = 4 * (n * d + n + 2 * d + 1)
    flops = 4 * n * d
    b_ms = bytes_ / PEAK_BYTES_S * 1e3
    f_ms = flops / PEAK_F32_FLOPS_S * 1e3
    return {"bound_ms": max(b_ms, f_ms), "bytes_bound_ms": b_ms,
            "flops_bound_ms": f_ms,
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


def library_pair(torch, X, y, w, loss):
    """Yardstick the port never calls: cuBLAS GEMV, elementwise loss,
    cuBLAS GEMV on Xᵀ."""
    m = y * torch.mv(X, w)
    if loss == "squared_hinge":
        h = torch.clamp(1.0 - m, min=0.0)
        L, dm = (h * h).sum(), -2.0 * h
    else:
        L, dm = torch.nn.functional.softplus(-m).sum(), -torch.sigmoid(-m)
    return L, torch.mv(X.t(), dm * y)


def kernel_phase(torch, rt) -> dict:
    lg, ref, synthetic = rt["linear_grad"], rt["ref"], rt["synthetic"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    spin_rate = spin_cycles_per_s(torch)
    main = None
    for label, n, d, how in KERNEL_SHAPES:
        if how[0] == "load":
            ds = synthetic.load(how[1], scale=how[2], device="cuda")
            X, y = ds.X, ds.y
            if tuple(X.shape) != (n, d):
                raise SystemExit(f"{label}: generator gave {tuple(X.shape)}")
        else:
            X = torch.randn((n, d), generator=gen, device="cuda")
            y = torch.sign(torch.randn((n,), generator=gen, device="cuda"))
            y[y == 0] = 1.0
        w = 0.1 * torch.randn((d,), generator=gen, device="cuda")
        X64, y64, w64 = X.double(), y.double(), w.double()
        for loss in LOSSES:
            L, g = lg.linear_value_grad(X, y, w, loss=loss)
            torch.cuda.synchronize()
            L64, g64 = ref.linear_value_grad(X64, y64, w64, loss=loss)
            err_L = abs(float(L) - float(L64))
            err_g = float((g.double() - g64).abs().max())
            g_scale = max(1.0, float(g64.abs().max()))
            ok = (math.isfinite(float(L)) and bool(torch.isfinite(g).all())
                  and err_L <= RTOL_L * abs(float(L64))
                  and err_g <= TOL_G * g_scale)
            fns = {"kernel": lambda: lg.linear_value_grad(X, y, w, loss=loss),
                   "plain": lambda: ref.linear_value_grad(X, y, w, loss=loss),
                   "library": lambda: library_pair(torch, X, y, w, loss)}
            row = {"kernel": "linear_value_grad", "shape": label, "n": n,
                   "d": d, "loss": loss, "err_L": err_L,
                   "rel_err_L": err_L / abs(float(L64)), "err_g": err_g,
                   "rel_err_g": err_g / g_scale,
                   **bounds_ms(n, d), "check": "pass" if ok else "FAIL"}
            for k, f in fns.items():
                t = time_ms(torch, f, spin_rate)
                row[f"{k}_ms"], row[f"{k}_call_ms"] = t["ms"], t["call_ms"]
            emit(row)
            if not ok:
                raise SystemExit(f"linear_value_grad disagrees with its "
                                 f"float64 plain version at {label}/{loss}")
            if (n, d) == MAIN_SHAPE and loss == "squared_hinge":
                main = dict(row, max_abs_err=max(err_L, err_g))
        del X, y, X64, y64
    return main


def quickstart_specs(api):
    data = api.DataSpec(dataset="w8a_like", scale=6.0, lam=1e-3)
    base = dict(data=data,
                optimizer=api.OptimizerSpec("newton_cg",
                                            {"hessian_fraction": 0.2}),
                schedule=api.ScheduleSpec(n0=128, clock={"p": 10.0, "a": 1.0,
                                                         "s": 5.0}))
    return data, base


def finite(tr) -> bool:
    vals = tr.column("f_window") + tr.column("f_full")
    return all(math.isfinite(v) for v in vals) and \
        bool(np.isfinite(tr.params.cpu().numpy()).all())


def main_path_phase(torch, rt) -> int:
    api, ops, linear = rt["api"], rt["ops"], rt["linear"]
    data, base = quickstart_specs(api)
    ds, objective, w0 = api.convex_problem(data, device="cuda")
    full = (ds.X, ds.y)
    _, f_star = linear.solve_reference(objective, w0, full, steps=60)
    sessions = {
        "two_track": api.build(api.RunSpec(
            policy=api.PolicySpec("two_track", {"final_steps": 20}), **base),
            device="cuda"),
        "batch": api.build(api.RunSpec(
            policy=api.PolicySpec("batch", {"steps": 25}), **base),
            device="cuda"),
    }
    torch.cuda.synchronize()
    ops.reset_calls()
    traces, walls = {}, {}
    for name, sess in sessions.items():
        t0 = time.perf_counter()
        traces[name] = sess.run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    launches = dict(ops.CALLS)
    implied = sum(2 if "f_fast_on_t" in p.extra else 1
                  for tr in traces.values() for p in tr.points)
    for name, sess in sessions.items():
        tr = traces[name]
        row = {"run": name, "stages": tr.meta["stages"],
               "steps": len(tr.points), "sim_time": sess.clock.time,
               "data_accesses": sess.clock.data_accesses,
               "host_transfers": tr.meta["host_transfers"],
               "wall_s": walls[name], "f_full": tr.final().f_full,
               "log_rfvd": float(linear.rfvd(objective, tr.params, full,
                                             f_star)),
               "test_acc": float(linear.accuracy(tr.params, ds.X_test,
                                                 ds.y_test))}
        if name == "two_track":
            ends = sess.stage_ends
            row["race_steps_per_stage"] = [
                b["step_count"] - a["step_count"]
                for a, b in zip([{"step_count": 0}] + ends, ends)]
            row["transfers_per_stage"] = [
                b["transfers"] - a["transfers"]
                for a, b in zip([{"transfers": 0}] + ends, ends)]
        emit(row)
        if not finite(tr):
            raise SystemExit(f"{name}: non-finite values in the trace")
    planned = sorted({i.n_t for i in sessions["two_track"].stage_plan()})
    reached = sorted(set(traces["two_track"].column("window")))
    if reached != planned:
        raise SystemExit(f"two_track reached windows {reached}, its stage "
                         f"plan has {planned}")
    emit({"launches": launches, "implied_optimizer_steps": implied})
    if launches.get("linear_value_grad", 0) != implied:
        raise SystemExit(f"linear_value_grad launched "
                         f"{launches.get('linear_value_grad', 0)} times, the "
                         f"traces imply {implied} optimizer steps")
    return launches["linear_value_grad"]


def card_vs_cpu_phase(torch, rt) -> None:
    api = rt["api"]
    _, base = quickstart_specs(api)
    spec = api.RunSpec(policy=api.PolicySpec("fixed_steps", {}), **base)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = api.build(spec, device=device).run()
        if device == "cuda":
            torch.cuda.synchronize()
        out[device + "_wall_s"] = time.perf_counter() - t0
    gpu, cpu = out["cuda"], out["cpu"]
    for col in ("step", "stage", "window", "time", "accesses"):
        if gpu.column(col) != cpu.column(col):
            raise SystemExit(f"fixed_steps card/CPU column {col!r} differs")
    f_gpu = np.array(gpu.column("f_full"))
    f_cpu = np.array(cpu.column("f_full"))
    rel = float(np.max(np.abs(f_gpu - f_cpu) / np.abs(f_cpu)))
    emit({"card_vs_cpu": "fixed_steps", "steps": len(gpu.points),
          "columns_equal": True, "max_rel_f_full": rel, "rtol": RTOL_F,
          "cuda_wall_s": out["cuda_wall_s"], "cpu_wall_s": out["cpu_wall_s"]})
    if not rel <= RTOL_F:
        raise SystemExit(f"fixed_steps f_full card/CPU rel diff {rel} > "
                         f"{RTOL_F}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch import api
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, linear_grad, ops, ref
    from repro_torch.models import linear
    rt = dict(api=api, synthetic=synthetic, linear_grad=linear_grad,
              ops=ops, ref=ref, linear=linear)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    libs = build.build()
    ptxas = [line.strip() for name, path in libs.items()
             for line in path.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit({"build_s": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(root)) for k, v in libs.items()},
          "ptxas": ptxas})

    # 2. kernels against their plain versions
    main_row = kernel_phase(torch, rt)
    # 3. the main path, with launch counts
    launches = main_path_phase(torch, rt)
    # 4. card against CPU
    card_vs_cpu_phase(torch, rt)

    emit({"kernels": [{
        "name": "linear_value_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_grad.cu",
        "replaces": "src/repro/kernels/linear_grad.py:50",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "call_ms": main_row["kernel_call_ms"],
        "shape": list(MAIN_SHAPE), "check": main_row["check"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
