#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100:
the kernels are built for sm_90a).  Phases, in order; any failure ends
the script with a non-zero exit and no result line:

 1. environment — the card's name and power limit (nvidia-smi), the torch
    and CUDA versions; TF32 off; every kernel built from the sources in
    the checkout (one nvcc per source, all started together); the SASS
    opcodes that show each kernel's units (B2 must hold HGMMA and UTMALDG).
 2. kernels — each kernel against its plain PyTorch version computed in
    float64 on the card, at the shapes the main paths give it, timed with
    CUDA events (the card's time, and the time per call with the host's
    share) beside its bound, its plain version and a library yardstick
    where one PyTorch call computes the same function.  One JSON line per
    shape.  B1 (linear_value_grad), B3 (ssm_scan), B4 (rglru_scan) — the
    scans' plain versions timed as CUDA graph replays (graph_ms) — and B2
    (flash_attention).
 3. main paths — ``repro_torch.api.build(spec, device="cuda").run()``,
    each path with the launch counts zeroed just before it and read just
    after:
    a. convex: the quickstart spec (examples/quickstart.py) at scale 6,
       two-track then batch; linear_value_grad launches exactly once per
       optimizer step the traces and the race overshoot imply;
    b. LM: falcon-mamba-7b at its full published width, depth cut to 4
       layers, two-track (launch/train.py's spec); ssm_scan launches
       num_layers times per forward pass the trace and the race
       overshoot imply; at most ⌈log₂ s⌉ host transfers per racing stage
       of s steps; f̂ on the eval probe falls; one line per stage;
    c. hybrid LM: recurrentgemma-9b at its full published width, depth
       cut to one (rec, rec, attn) super-block, under fixed_steps
       (launch/train.py's default schedule) on sequences of 4,096 tokens,
       longer than its 2,048 local window; rglru_scan launches twice and
       flash_attention once per forward pass the trace implies; f̂ falls;
       one line per stage, the peak memory, a train step taken apart.
 4. card against CPU — the convex workload, and the reduced LMs (mamba
    and hybrid) in float32, under fixed_steps on the card and on the CPU
    (plain versions): clock and access columns equal, f̂ within rtol 1e-4.

Then the ``{"kernels": [...]}`` line, and last ``{"ok": true, ...}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# outside the tensor cores, dense bfloat16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12
PEAK_BF16_FLOPS_S = 989e12

# Kernel check tolerance against the float64 plain version.  The kernel
# accumulates in float32: per-lane partials over a warp's rows, a fixed
# warp order within a block, then a fixed-order sum over at most
# 4 x SMs block partials.  Rounding grows like sqrt(terms) x 6e-8, i.e.
# ~1e-6 relative at n = 4M; 1e-5 on L and 1e-4 on g leave an order of
# magnitude of room and still catch a dropped row, a wrong loss branch or
# a racy reduction (all far above 1e-3).
RTOL_L = 1e-5
TOL_G = 1e-4
# card-vs-CPU main paths: the same algorithm in float32 with different
# summation orders (cuBLAS and the kernels vs CPU BLAS and the plain
# versions); 1e-4 relative on f̂ after ~100 Newton-CG steps, and after 6
# AdamW steps of the reduced LM (each moves a weight by about lr, so
# gradients that differ in the last digits move them alike)
RTOL_F = 1e-4

# B3 against its float64 plain version (elementwise, relative to
# max(1, |y|)): float32 carries h in float32 and takes exp as exp2 on the
# SFU (2 ulp) over S steps of a contracting recurrence, rounding near
# 1e-6, so 1e-4; bfloat16 rounds y itself to bfloat16 (half an ulp is
# 2^-9 = 2e-3), so 1e-2.  A dropped step, a wrong state or a wrong decay
# is far above both.
SCAN_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# H100 SXM: 132 SMs, 16 SFU results a clock each, 1.98 GHz boost (NVIDIA
# Hopper whitepaper; CUDA guide throughput table for compute capability 9.0)
SFU_EXP_S = 132 * 16 * 1.98e9

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

# the LM main path (launch/train.py:76-128, two_track): falcon-mamba-7b at
# full width, 4 of its 64 identical layers
LM_LAYERS = 4
LM_BATCH, LM_SEQ = 8, 256
LM_CORPUS, LM_MAX_STAGE_ITERS = 512, 16
# B3 shapes: (label, B, S, di, N); the first is what the LM path's train
# step gives it, the second its f̂ probe (eval_rows 16), where 608 of the
# run's 1,024 launches fall
SCAN_SHAPES = [
    ("falcon-mamba-7b", LM_BATCH, LM_SEQ, 8192, 16),
    ("probe", 16, LM_SEQ, 8192, 16),
    ("ragged", 3, 77, 8192 + 40, 16),
    ("small", 1, 32, 64, 4),
]

# the hybrid main path (launch/train.py's default schedule, fixed_steps):
# recurrentgemma-9b at full width, one (rec, rec, attn) super-block of its
# 38 layers; sequences of 4,096 tokens exceed the 2,048 local window
HY_LAYERS = 3
HY_BATCH, HY_SEQ = 2, 4096
HY_CORPUS, HY_EVAL_ROWS, HY_N0 = 512, 16, 64
HY_INNER, HY_FINAL = 8, 8
HY_WIDTH, HY_HEADS, HY_KV, HY_HD, HY_WINDOW = 4096, 16, 1, 256, 2048
# B4 against its float64 plain version, elementwise relative to 1 + |y|:
# float32 carries h in float32 through a contracting recurrence (one
# rounding a step, damped), 1e-5; bfloat16 rounds each y to bfloat16,
# 5e-2 (the reference's own bounds, tests/test_kernels.py)
RGLRU_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# B4 shapes (label, B, S, W, dtypes); the first is what the hybrid path's
# train step gives it, the second its f̂ probe
RGLRU_SHAPES = [
    ("recurrentgemma-9b", HY_BATCH, HY_SEQ, HY_WIDTH,
     ("bfloat16", "float32")),
    ("probe", HY_EVAL_ROWS, HY_SEQ, HY_WIDTH, ("bfloat16",)),
    ("ragged", 3, 77, HY_WIDTH + 40, ("bfloat16", "float32")),
]
# B2 against its float64 plain version, elementwise relative to 1 + |o|:
# float32 accumulates in float32 over at most S keys, 1e-4; bfloat16
# rounds o to bfloat16, 2e-2 (the reference's own bounds)
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# B2 shapes (label, B, S, H, KV, hd, window, dtype); the first is the
# hybrid path's train step, the second its f̂ probe (whose plain version
# and library call would hold ~70 GB of S x S scores, so only the kernel
# is timed there)
ATTN_SHAPES = [
    ("recurrentgemma-9b", HY_BATCH, HY_SEQ, HY_HEADS, HY_KV, HY_HD,
     HY_WINDOW, "bfloat16"),
    ("probe", HY_EVAL_ROWS, HY_SEQ, HY_HEADS, HY_KV, HY_HD, HY_WINDOW,
     "bfloat16"),
    ("ragged", 1, 1000, HY_HEADS, HY_KV, HY_HD, 300, "bfloat16"),
    ("ragged_f32", 1, 1000, HY_HEADS, HY_KV, HY_HD, 300, "float32"),
    ("f32_hd64_w48", 2, 512, 8, 2, 64, 48, "float32"),
    ("gqa16_f32", 1, 384, 16, 1, 128, 0, "float32"),
]


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


def graph_ms(torch, fn, iters: int = 10) -> dict:
    """Card time of ``fn`` for a function of thousands of small launches
    (the plain scan's Python loop), whose enqueue outruns any spin: the
    launch queue fills behind the spin kernel and blocks the host.  One
    call is captured into a CUDA graph and replayed back to back, which
    the card runs without host gaps (``ms``); ``call_ms`` is the eager
    calls back to back, as a caller issues them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"ms": ms, "call_ms": start.elapsed_time(end) / iters}


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


def scan_bounds_ms(B: int, S: int, di: int, N: int, elt: int) -> dict:
    """Least time for ssm_scan's work: read u, delta (B, S, di), B, C
    (B, S, N), A_log (di, N) and D (di,) once, write y once; per (t,
    channel) N·(multiply, exp, 2 FMAs = 4 flops) + 3 float32 operations.
    The exps run on the SFU, whose rate the peak table does not give:
    ``sfu_bound_ms`` states them at 16 a clock per SM beside the bound."""
    bytes_ = elt * (3 * B * S * di + 2 * B * S * N) + 4 * (di * N + di)
    flops = B * S * di * (6 * N + 3)
    b_ms = bytes_ / PEAK_BYTES_S * 1e3
    f_ms = flops / PEAK_F32_FLOPS_S * 1e3
    return {"bound_ms": max(b_ms, f_ms), "bytes_bound_ms": b_ms,
            "flops_bound_ms": f_ms,
            "sfu_bound_ms": B * S * di * N / SFU_EXP_S * 1e3,
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


def scan_inputs(torch, gen, B, S, di, N, dtype):
    """The reference test's distributions: u, B, C standard normal,
    delta = softplus(normal), A_log = log(1..N), D normal."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u, dt = randn(B, S, di), torch.nn.functional.softplus(randn(B, S, di))
    Bs, Cs = randn(B, S, N), randn(B, S, N)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device="cuda")).expand(di, N).contiguous()
    return [x.to(dtype) for x in (u, dt, Bs, Cs)] + [A_log, randn(di)]


def scan_kernel_phase(torch, rt) -> dict:
    ops, ref = rt["ops"], rt["ref"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    spin_rate = spin_cycles_per_s(torch)
    rows = {}
    for label, B, S, di, N in SCAN_SHAPES:
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            args = scan_inputs(torch, gen, B, S, di, N, dtype)
            y = ops.ssm_scan(*args)
            torch.cuda.synchronize()
            y64 = ref.ssm_scan(*(a.double() for a in args))
            err = (y.double() - y64).abs()
            max_abs = float(err.max())
            rel = float((err / (1.0 + y64.abs())).max())
            ok = bool(torch.isfinite(y).all()) and rel <= SCAN_TOL[dname]
            row = {"kernel": "ssm_scan", "shape": label, "B": B, "S": S,
                   "di": di, "N": N, "dtype": dname, "max_abs_err": max_abs,
                   "max_rel_err": rel, "tol": SCAN_TOL[dname],
                   **scan_bounds_ms(B, S, di, N, y.element_size()),
                   "library_ms": None, "check": "pass" if ok else "FAIL"}
            for k, t in (
                    ("kernel", time_ms(torch, lambda: ops.ssm_scan(*args),
                                       spin_rate)),
                    ("plain", graph_ms(torch, lambda: ref.ssm_scan(*args)))):
                row[f"{k}_ms"], row[f"{k}_call_ms"] = t["ms"], t["call_ms"]
            emit(row)
            if not ok:
                raise SystemExit(f"ssm_scan disagrees with its float64 plain "
                                 f"version at {label}/{dname}: {rel}")
            if dname == "bfloat16" and label in ("falcon-mamba-7b",
                                                 "probe"):
                rows[label] = row
            del args, y, y64, err
    return rows


def rglru_bounds_ms(B: int, S: int, W: int, elt: int) -> dict:
    """Least time for rglru_scan's work: read a, b once and write y once;
    one FMA (2 float32 operations) per element."""
    bytes_ = 3 * elt * B * S * W
    b_ms = bytes_ / PEAK_BYTES_S * 1e3
    f_ms = 2 * B * S * W / PEAK_F32_FLOPS_S * 1e3
    return {"bound_ms": max(b_ms, f_ms), "bytes_bound_ms": b_ms,
            "flops_bound_ms": f_ms,
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


def rglru_inputs(torch, gen, B, S, W, dtype):
    """The reference test's distributions: a = sigmoid(normal) in (0, 1),
    b standard normal."""
    a = torch.sigmoid(torch.randn((B, S, W), generator=gen, device="cuda"))
    b = torch.randn((B, S, W), generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype)


def rglru_kernel_phase(torch, rt) -> dict:
    ops, ref = rt["ops"], rt["ref"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    spin_rate = spin_cycles_per_s(torch)
    main = None
    for label, B, S, W, dnames in RGLRU_SHAPES:
        for dname in dnames:
            a, b = rglru_inputs(torch, gen, B, S, W, getattr(torch, dname))
            y = ops.rglru_scan(a, b)
            torch.cuda.synchronize()
            y64 = ref.rglru_scan(a.double(), b.double())
            err = (y.double() - y64).abs()
            max_abs = float(err.max())
            rel = float((err / (1.0 + y64.abs())).max())
            del y64, err
            ok = bool(torch.isfinite(y).all()) and rel <= RGLRU_TOL[dname]
            row = {"kernel": "rglru_scan", "shape": label, "B": B, "S": S,
                   "W": W, "dtype": dname, "max_abs_err": max_abs,
                   "max_rel_err": rel, "tol": RGLRU_TOL[dname],
                   **rglru_bounds_ms(B, S, W, y.element_size()),
                   "library_ms": None, "check": "pass" if ok else "FAIL"}
            for k, t in (
                    ("kernel", time_ms(torch, lambda: ops.rglru_scan(a, b),
                                       spin_rate)),
                    ("plain", graph_ms(torch,
                                       lambda: ref.rglru_scan(a, b)))):
                row[f"{k}_ms"], row[f"{k}_call_ms"] = t["ms"], t["call_ms"]
            emit(row)
            if not ok:
                raise SystemExit(f"rglru_scan disagrees with its float64 "
                                 f"plain version at {label}/{dname}: {rel}")
            if label == RGLRU_SHAPES[0][0] and dname == "bfloat16":
                main = row
            del a, b, y
    return main


def attention_pairs(B: int, S: int, H: int, window: int) -> int:
    """(query, key) pairs causal attention with ``window`` scores."""
    per_head = sum(min(q + 1, window) if window else q + 1
                   for q in range(S))
    return B * H * per_head


def attention_bounds_ms(B, S, H, KV, hd, window, dname) -> dict:
    """Least time for flash_attention's work: read q, k, v once (k and v
    unrepeated) and write o once; 4·hd operations per unmasked (query,
    key) pair (QKᵀ and PV), at the peak of the inputs' type (the tensor
    cores' for bfloat16, the CUDA cores' for float32)."""
    elt = 2 if dname == "bfloat16" else 4
    bytes_ = elt * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    flops = 4 * hd * attention_pairs(B, S, H, window)
    peak = PEAK_BF16_FLOPS_S if dname == "bfloat16" else PEAK_F32_FLOPS_S
    b_ms = bytes_ / PEAK_BYTES_S * 1e3
    f_ms = flops / peak * 1e3
    return {"bound_ms": max(b_ms, f_ms), "bytes_bound_ms": b_ms,
            "flops_bound_ms": f_ms, "gflop": flops / 1e9,
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


def attention64(torch, ref, q, k, v, window):
    """The plain version in float64, one batch row at a time (the S x S
    scores of a whole probe batch would not fit)."""
    return torch.cat([ref.gqa_attention(q[i:i + 1].double(),
                                        k[i:i + 1].double(),
                                        v[i:i + 1].double(), window=window)
                      for i in range(q.shape[0])])


def library_attention(torch, q, k, v, window):
    """Yardstick the port never calls: PyTorch's fused attention with a
    boolean causal-and-window mask, GQA by head groups."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    ok = pos[None, :] <= pos[:, None]
    if window:
        ok &= (pos[:, None] - pos[None, :]) < window
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=ok, enable_gqa=True)
    return out.transpose(1, 2)


def attention_kernel_phase(torch, rt) -> dict:
    ops, ref = rt["ops"], rt["ref"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    spin_rate = spin_cycles_per_s(torch)
    main = None
    for label, B, S, H, KV, hd, window, dname in ATTN_SHAPES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn((B, S, n, hd), generator=gen,
                               device="cuda").to(dtype)
                   for n in (H, KV, KV))
        o = ops.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        o64 = attention64(torch, ref, q, k, v, window)
        err = (o.double() - o64).abs()
        max_abs = float(err.max())
        rel = float((err / (1.0 + o64.abs())).max())
        del o64, err
        ok = bool(torch.isfinite(o).all()) and rel <= ATTN_TOL[dname]
        row = {"kernel": "flash_attention", "shape": label, "B": B, "S": S,
               "H": H, "KV": KV, "hd": hd, "window": window, "dtype": dname,
               "max_abs_err": max_abs, "max_rel_err": rel,
               "tol": ATTN_TOL[dname],
               **attention_bounds_ms(B, S, H, KV, hd, window, dname),
               "check": "pass" if ok else "FAIL"}
        fns = {"kernel": lambda: ops.flash_attention(q, k, v, window=window)}
        if label == "probe":
            row["note"] = ("plain and library not timed: their S x S scores "
                           "at this batch would hold ~70 GB")
        else:
            fns["plain"] = lambda: ref.gqa_attention(q, k, v, window=window)
            fns["library"] = lambda: library_attention(torch, q, k, v,
                                                       window)
        for name in ("kernel", "plain", "library"):
            t = (time_ms(torch, fns[name], spin_rate, iters=10)
                 if name in fns else {"ms": None, "call_ms": None})
            row[f"{name}_ms"], row[f"{name}_call_ms"] = t["ms"], t["call_ms"]
        emit(row)
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its float64 "
                             f"plain version at {label}: {rel}")
        if label == ATTN_SHAPES[0][0]:
            main = row
        if label == "probe":
            main["probe_ms"] = row["kernel_ms"]
            main["probe_bound_ms"] = row["bound_ms"]
        del q, k, v, o
        torch.cuda.empty_cache()
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
    # two launches per race step (the steps run past a trigger and
    # discarded included), one per final-phase and batch step
    overshoot = sum(tr.meta["race_overshoot"] for tr in traces.values())
    implied = sum(2 if "f_fast_on_t" in p.extra else 1
                  for tr in traces.values() for p in tr.points) \
        + 2 * overshoot
    for name, sess in sessions.items():
        tr = traces[name]
        row = {"run": name, "stages": tr.meta["stages"],
               "steps": len(tr.points), "sim_time": sess.clock.time,
               "data_accesses": sess.clock.data_accesses,
               "host_transfers": tr.meta["host_transfers"],
               "race_overshoot": tr.meta["race_overshoot"],
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
    emit({"path": "convex", "launches": launches,
          "implied_optimizer_steps": implied, "race_overshoot": overshoot})
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


def lm_spec(api, *, arch: str = "falcon-mamba-7b", reduced: bool, policy,
            corpus: int, seq_len: int, n0: int,
            max_stage_iters: int | None = None, layers: int = LM_LAYERS,
            batch: int = LM_BATCH, eval_rows: int = 16,
            fixed: tuple = (3, 3)):
    """launch/train.py's LM RunSpec (to_run_spec): the host-slice token
    path, adamw_lm, a batch-cost clock that waits on expansion and carries
    the Adam moments across stages."""
    if reduced:
        model = api.ModelSpec(arch=arch, reduced=True,
                              overrides={"dtype": "float32"})
    else:
        model = api.ModelSpec(arch=arch, reduced=False,
                              overrides={"num_layers": layers})
    if policy == "two_track":
        pol = api.PolicySpec("two_track", {
            "final_steps": 8, "max_stage_iters": max_stage_iters,
            "condition": "eval", "final_eval_full": True})
    else:
        pol = api.PolicySpec("fixed_steps", {"inner_steps": fixed[0],
                                             "final_steps": fixed[1]})
    return api.RunSpec(
        name=f"lm_{policy}",
        data=api.DataSpec(kind="lm", corpus_size=corpus, seq_len=seq_len,
                          eval_rows=eval_rows, plane="host"),
        model=model, policy=pol,
        optimizer=api.OptimizerSpec("adamw_lm", {"lr": 3e-4,
                                                 "batch_size": batch}),
        schedule=api.ScheduleSpec(n0=n0, step_cost="batch",
                                  wait_on_expand=True, carry_state=True,
                                  clock={"preloaded": n0}))


def stage_lines(sess, tr, stamps, f0, t0, path: str) -> list:
    """One line per stage of a finished LM run (``stamps``: the host clock
    at each stage's end, after a synchronize); returns the lines."""
    rows = []
    prev = {"step_count": 0, "transfers": 0, "overshoot": 0}
    f_before, t_prev = f0, t0
    for end, stamp in zip(sess.stage_ends, stamps):
        pts = [p for p in tr.points if p.stage == end["stage"]]
        stage_s = stamp - t_prev
        row = {"path": path, "stage": end["stage"], "window": end["n_t"],
               "racing": "f_fast_on_t" in pts[0].extra, "steps": len(pts),
               "host_transfers": end["transfers"] - prev["transfers"],
               "race_overshoot": end["overshoot"] - prev["overshoot"],
               "wall_s": stage_s, "wall_s_per_step": stage_s / len(pts),
               "f_full_before": f_before, "f_full_after": pts[-1].f_full,
               "f_window_last": pts[-1].f_window}
        emit(row)
        rows.append(row)
        prev, f_before, t_prev = end, pts[-1].f_full, stamp
    return rows


def timed_run(torch, sess):
    """Run ``sess`` with its stage ends stamped on the host clock after a
    synchronize; returns (trace, stamps, t0, wall seconds)."""
    stamps, record = [], sess.engine.stage_callback

    def timed(end):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        record(end)

    sess.engine.stage_callback = timed
    t0 = time.perf_counter()
    tr = sess.run()
    torch.cuda.synchronize()
    return tr, stamps, t0, time.perf_counter() - t0


def lm_main_path_phase(torch, rt) -> dict:
    api, ops = rt["api"], rt["ops"]
    spec = lm_spec(api, reduced=False, policy="two_track", corpus=LM_CORPUS,
                   seq_len=LM_SEQ, n0=64, max_stage_iters=LM_MAX_STAGE_ITERS)
    t0 = time.perf_counter()
    sess = api.build(spec, device="cuda")
    cfg = sess.model_config
    n_params = sum(t.numel() for t in rt["tree_leaves"](sess.w0))
    f0 = float(sess.objective(sess.w0, sess.eval_data))
    torch.cuda.synchronize()
    emit({"path": "lm", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "ssm_state": cfg.ssm_state, "dt_rank": cfg.dt_rank,
          "vocab": cfg.vocab_size, "dtype": str(cfg.dtype),
          "params": n_params, "build_s": time.perf_counter() - t0,
          "f_full_w0": f0, "spec": spec.to_dict()})
    torch.cuda.reset_peak_memory_stats()
    ops.reset_calls()
    tr, stamps, t0, wall = timed_run(torch, sess)
    launches = dict(ops.CALLS)
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    rows = stage_lines(sess, tr, stamps, f0, t0, "lm")
    pol = sess.policy
    race = sum("f_fast_on_t" in p.extra for p in tr.points)
    final = len(tr.points) - race
    overshoot = tr.meta["race_overshoot"]
    # a race step: a train step on each track, then f̂_t of the fast track
    # and f̂ of the slow one, plus f̂_t of the slow one under "eval"; a
    # final step: a train step, plus f̂ when final_eval_full
    race_evals = 3 if pol.condition == "eval" else 2
    final_evals = 1 if pol.final_eval_full else 0
    train_steps = 2 * (race + overshoot) + final
    evals = race_evals * (race + overshoot) + final_evals * final
    implied = cfg.num_layers * (train_steps + evals)
    values = (tr.column("f_window") + tr.column("f_full")
              + [p.extra["f_fast_on_t"] for p in tr.points
                 if "f_fast_on_t" in p.extra])
    summary = {"path": "lm", "stages": tr.meta["stages"],
               "race_steps": race, "final_steps": final,
               "race_overshoot": overshoot,
               "host_transfers": tr.meta["host_transfers"],
               "transfers_per_stage": [r["host_transfers"] for r in rows],
               "train_steps": train_steps, "objective_evals": evals,
               "launches": launches, "implied_ssm_scan": implied,
               "wall_s": wall, "peak_memory_gb": peak / 1e9,
               "peak_reserved_gb": peak_reserved / 1e9,
               "f_full_w0": f0, "f_full_final": tr.final().f_full,
               "sim_time": sess.clock.time,
               "data_accesses": sess.clock.data_accesses}
    emit(summary)
    if not all(math.isfinite(v) for v in values):
        raise SystemExit("LM: non-finite loss in the trace")
    if not tr.final().f_full < f0:
        raise SystemExit(f"LM: f̂ on the eval probe did not fall "
                         f"({f0} -> {tr.final().f_full})")
    if launches.get("ssm_scan", 0) != implied:
        raise SystemExit(f"ssm_scan launched {launches.get('ssm_scan', 0)} "
                         f"times, the trace implies {implied}")
    # the race pulls once per chunk (cumulative sizes 2, 4, 8, ...)
    for r in rows:
        if r["racing"] and r["host_transfers"] > \
                math.ceil(math.log2(max(2, r["steps"]))):
            raise SystemExit(f"racing stage {r['stage']} of {r['steps']} "
                             f"steps took {r['host_transfers']} transfers")
    lm_step_breakdown(torch, rt, sess, tr.params)
    del sess, tr
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def graph_nodes(loss) -> set:
    """Every node of ``loss``'s autograd graph."""
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(f for f, _ in node.next_functions)
    return seen


def step_breakdown(torch, rt, sess, params, batch_size: int, path: str,
                   parts: dict) -> dict:
    """Where a train step's time goes: host-clock segments, each ended by
    a synchronize, of one step taken apart (forward with the graph, the
    backward, the AdamW update), one f̂ probe, and each kernel's share of
    the forward and of the backward.  ``parts`` maps a name to (inputs,
    kernel call, calls per step, its autograd node's name): the kernel
    forward is timed alone at the path's shape; its plain-version VJP is
    timed inside the step's backward, from a pre-hook to a hook on each
    of its nodes, both ended by a synchronize.  Taken after the main
    path's counts were read; the launches here are not counted there."""
    T, adam, tree_map = rt["transformer"], rt["adam"], rt["tree_map"]
    cfg = sess.model_config
    rows = sess.dataset.window(batch_size)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    opt_state = adam.adamw_init(params)
    seg = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seg[name] = seg.get(name, 0.0) + time.perf_counter() - t0
        return out

    def hook_vjps(loss) -> list:
        handles = []
        for node in graph_nodes(loss):
            for name, (_, _, _, node_name) in parts.items():
                if node.name() != node_name:
                    continue
                start = []

                def pre(_, start=start):
                    torch.cuda.synchronize()
                    start.append(time.perf_counter())

                def post(_, __, name=name, start=start):
                    torch.cuda.synchronize()
                    key = f"{name}_vjp_in_backward_s"
                    seg[key] = seg.get(key, 0.0) \
                        + time.perf_counter() - start.pop()
                    seg[f"{name}_vjp_nodes"] = \
                        seg.get(f"{name}_vjp_nodes", 0) + 1

                handles += [node.register_prehook(pre),
                            node.register_hook(post)]
        return handles

    for rep in range(2):                # the first is a warm-up
        seg.clear()
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = timed("forward_s", lambda: T.loss_fn(
                cfg, p, batch, impl="pallas")[0])
            leaves = rt["tree_leaves"](p)
            handles = hook_vjps(loss)
            flat = timed("backward_s",
                         lambda: torch.autograd.grad(loss, leaves))
            for h in handles:
                h.remove()
        it = iter(flat)
        grads = tree_map(lambda _: next(it), p)
        del p, loss, flat
        timed("adamw_s", lambda: adam.adamw_update(
            params, grads, opt_state, lr=3e-4, weight_decay=0.1))
        del grads
        timed("probe_s", lambda: sess.objective(params, sess.eval_data))
        for name, (inputs, call, _, _) in parts.items():
            args = [a.requires_grad_(True) for a in inputs()]
            timed(f"{name}_forward_s", lambda: call(*args))
            del args
    out = {"path": path, "breakdown": "one train step", **seg,
           "layers": cfg.num_layers}
    for name, (_, _, count, _) in parts.items():
        if seg.get(f"{name}_vjp_nodes") != count:
            raise SystemExit(f"{path} breakdown: {count} {name} calls a "
                             f"step, {seg.get(f'{name}_vjp_nodes')} of its "
                             f"nodes ran in the backward")
        out[f"{name}_calls_per_step"] = count
        out[f"{name}_forward_share_of_forward"] = \
            seg[f"{name}_forward_s"] * count / seg["forward_s"]
        out[f"{name}_vjp_share_of_backward"] = \
            seg[f"{name}_vjp_in_backward_s"] / seg["backward_s"]
    emit(out)
    return out


def lm_step_breakdown(torch, rt, sess, params) -> None:
    cfg = sess.model_config
    gen = torch.Generator(device="cuda").manual_seed(2)
    parts = {"scan": (lambda: scan_inputs(torch, gen, LM_BATCH, LM_SEQ,
                                          cfg.d_inner, cfg.ssm_state,
                                          cfg.dtype),
                      rt["ops"].ssm_scan, cfg.num_layers,
                      "_SSMScanBackward")}
    step_breakdown(torch, rt, sess, params, LM_BATCH, "lm", parts)


def hybrid_main_path_phase(torch, rt) -> dict:
    """recurrentgemma-9b at full width, one super-block, fixed_steps."""
    api, ops = rt["api"], rt["ops"]
    spec = lm_spec(api, arch="recurrentgemma-9b", reduced=False,
                   policy="fixed_steps", corpus=HY_CORPUS, seq_len=HY_SEQ,
                   n0=HY_N0, layers=HY_LAYERS, batch=HY_BATCH,
                   eval_rows=HY_EVAL_ROWS, fixed=(HY_INNER, HY_FINAL))
    t0 = time.perf_counter()
    sess = api.build(spec, device="cuda")
    cfg = sess.model_config
    n_params = sum(t.numel() for t in rt["tree_leaves"](sess.w0))
    f0 = float(sess.objective(sess.w0, sess.eval_data))
    torch.cuda.synchronize()
    emit({"path": "hybrid", "arch": cfg.name, "layers": cfg.num_layers,
          "layer_types": list(cfg.layer_types()), "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
          "lru_width": cfg.lru_width, "local_window": cfg.local_window,
          "vocab": cfg.vocab_size, "dtype": str(cfg.dtype),
          "params": n_params, "build_s": time.perf_counter() - t0,
          "f_full_w0": f0, "spec": spec.to_dict()})
    if not HY_SEQ > cfg.local_window:
        raise SystemExit("the hybrid path's sequences must exceed the window")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_calls()
    tr, stamps, t0, wall = timed_run(torch, sess)
    launches = dict(ops.CALLS)
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    rows = stage_lines(sess, tr, stamps, f0, t0, "hybrid")
    # fixed_steps: a train step and an f̂ probe (eval_full) per step
    passes = 2 * len(tr.points)
    types = cfg.layer_types()
    implied = {"rglru_scan": types.count("rec") * passes,
               "flash_attention": types.count("attn") * passes}
    values = tr.column("f_window") + tr.column("f_full")
    summary = {"path": "hybrid", "stages": tr.meta["stages"],
               "steps": len(tr.points), "forward_passes": passes,
               "host_transfers": tr.meta["host_transfers"],
               "transfers_per_stage": [r["host_transfers"] for r in rows],
               "launches": launches, "implied": implied, "wall_s": wall,
               "wall_s_per_step": wall / len(tr.points),
               "peak_memory_gb": peak / 1e9,
               "peak_reserved_gb": peak_reserved / 1e9,
               "card_memory_gb": torch.cuda.get_device_properties(0)
               .total_memory / 1e9,
               "f_full_w0": f0, "f_full_first_stage": rows[0]["f_full_after"],
               "f_full_final": tr.final().f_full,
               "sim_time": sess.clock.time,
               "data_accesses": sess.clock.data_accesses}
    emit(summary)
    if not all(math.isfinite(v) for v in values):
        raise SystemExit("hybrid: non-finite loss in the trace")
    if not tr.final().f_full < rows[0]["f_full_after"]:
        raise SystemExit(f"hybrid: f̂ on the eval probe did not fall from "
                         f"the first stage to the last "
                         f"({rows[0]['f_full_after']} -> "
                         f"{tr.final().f_full})")
    for name, n in implied.items():
        if launches.get(name, 0) != n:
            raise SystemExit(f"{name} launched {launches.get(name, 0)} "
                             f"times, the trace implies {n}")
    params = tr.params
    sess.w0 = None                      # the breakdown needs the room
    del tr
    gc.collect()
    gen = torch.Generator(device="cuda").manual_seed(5)
    parts = {
        "rglru": (lambda: rglru_inputs(torch, gen, HY_BATCH, HY_SEQ,
                                       cfg.lru_width, cfg.dtype),
                  ops.rglru_scan, types.count("rec"), "_RGLRUScanBackward"),
        "attention": (lambda: [torch.randn(
            (HY_BATCH, HY_SEQ, n, cfg.head_dim), generator=gen,
            device="cuda").to(cfg.dtype)
            for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)],
            lambda q, k, v: ops.flash_attention(q, k, v,
                                                window=cfg.local_window),
            types.count("attn"), "_FlashAttentionBackward"),
    }
    summary["breakdown"] = step_breakdown(torch, rt, sess, params, HY_BATCH,
                                          "hybrid", parts)
    del sess, params
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def lm_card_vs_cpu_phase(torch, rt, arch: str) -> None:
    """The reduced LM in float32 under fixed_steps, on the card and on the
    CPU from the same parameters (the CPU session's, carried across)."""
    api = rt["api"]
    spec = lm_spec(api, arch=arch, reduced=True, policy="fixed_steps",
                   corpus=32, seq_len=32, n0=16)
    cpu_sess = api.build(spec, device="cpu")
    gpu_sess = api.build(spec, device="cuda")
    gpu_sess.w0 = rt["tree_map"](lambda t: t.cuda(), cpu_sess.w0)
    out = {}
    for device, sess in (("cuda", gpu_sess), ("cpu", cpu_sess)):
        t0 = time.perf_counter()
        out[device] = sess.run()
        if device == "cuda":
            torch.cuda.synchronize()
        out[device + "_wall_s"] = time.perf_counter() - t0
    gpu, cpu = out["cuda"], out["cpu"]
    for col in ("step", "stage", "window", "time", "accesses"):
        if gpu.column(col) != cpu.column(col):
            raise SystemExit(f"LM {arch} fixed_steps card/CPU column "
                             f"{col!r} differs")
    rel = float(np.max(np.abs(np.array(gpu.column("f_full"))
                              - np.array(cpu.column("f_full")))
                       / np.abs(np.array(cpu.column("f_full")))))
    emit({"card_vs_cpu": "lm_fixed_steps", "arch": arch,
          "steps": len(gpu.points), "columns_equal": True,
          "max_rel_f_full": rel, "rtol": RTOL_F,
          "cuda_wall_s": out["cuda_wall_s"], "cpu_wall_s": out["cpu_wall_s"]})
    if not rel <= RTOL_F:
        raise SystemExit(f"LM {arch} fixed_steps f_full card/CPU rel diff "
                         f"{rel} > {RTOL_F}")


# SASS opcodes that show which units a kernel runs on: HGMMA (wgmma),
# UTMALDG (TMA loads), SYNCS (mbarrier waits), HMMA and LDSM (mma.sync
# and ldmatrix), MUFU.EX2 (the SFU's exp2)
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "HMMA", "LDSM", "MUFU.EX2")


def sass_phase(libs: dict) -> dict:
    """Counts of SASS_OPS in each built library (cuobjdump -sass), one line
    a library; B2's bfloat16 kernel must run on wgmma fed by TMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name, path in libs.items():
        sass = subprocess.run([tool, "-sass", str(path)], check=True,
                              capture_output=True, text=True).stdout
        counts[name] = {op: sass.count(op) for op in SASS_OPS}
        emit({"sass": name, **counts[name]})
    fa = counts["flash_attention"]
    if not (fa["HGMMA"] and fa["UTMALDG"]) or fa["HMMA"]:
        raise SystemExit(f"flash_attention's SASS is not wgmma fed by TMA: "
                         f"{fa}")
    return counts


def main() -> None:
    # the full-width runs hold most of the card: segments that grow in
    # place keep the allocator's split blocks from stranding memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    from repro_torch.models import transformer
    from repro_torch.optim import adam
    from repro_torch.optim.api import tree_leaves, tree_map
    rt = dict(api=api, synthetic=synthetic, linear_grad=linear_grad,
              ops=ops, ref=ref, linear=linear, transformer=transformer,
              adam=adam, tree_map=tree_map, tree_leaves=tree_leaves)

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
    sass_phase(libs)

    # 2. kernels against their plain versions
    main_row = kernel_phase(torch, rt)
    scan_rows = scan_kernel_phase(torch, rt)
    scan_row = scan_rows["falcon-mamba-7b"]
    rglru_row = rglru_kernel_phase(torch, rt)
    attn_row = attention_kernel_phase(torch, rt)
    # 3. the main paths, each with its own launch counts
    launches = main_path_phase(torch, rt)
    lm = lm_main_path_phase(torch, rt)
    hybrid = hybrid_main_path_phase(torch, rt)
    # 4. card against CPU
    card_vs_cpu_phase(torch, rt)
    lm_card_vs_cpu_phase(torch, rt, "falcon-mamba-7b")
    lm_card_vs_cpu_phase(torch, rt, "recurrentgemma-9b")

    emit({"kernels": [{
        "name": "linear_value_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_grad.cu",
        "replaces": "src/repro/kernels/linear_grad.py:50",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "call_ms": main_row["kernel_call_ms"],
        "shape": list(MAIN_SHAPE), "check": main_row["check"]}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:45",
        "launches": lm["launches"]["ssm_scan"],
        "max_abs_err": scan_row["max_abs_err"],
        "ms": scan_row["kernel_ms"], "plain_ms": scan_row["plain_ms"],
        "bound_ms": scan_row["bound_ms"], "bound_by": scan_row["bound_by"],
        "library_ms": None, "call_ms": scan_row["kernel_call_ms"],
        "sfu_bound_ms": scan_row["sfu_bound_ms"],
        "probe_ms": scan_rows["probe"]["kernel_ms"],
        "probe_bound_ms": scan_rows["probe"]["bound_ms"],
        "shape": [scan_row["B"], scan_row["S"], scan_row["di"],
                  scan_row["N"]], "dtype": scan_row["dtype"],
        "check": scan_row["check"]}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:38",
        "launches": hybrid["launches"]["rglru_scan"],
        "max_abs_err": rglru_row["max_abs_err"],
        "ms": rglru_row["kernel_ms"], "plain_ms": rglru_row["plain_ms"],
        "bound_ms": rglru_row["bound_ms"],
        "bound_by": rglru_row["bound_by"], "library_ms": None,
        "call_ms": rglru_row["kernel_call_ms"],
        "shape": [rglru_row["B"], rglru_row["S"], rglru_row["W"]],
        "dtype": rglru_row["dtype"], "check": rglru_row["check"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": hybrid["launches"]["flash_attention"],
        "max_abs_err": attn_row["max_abs_err"],
        "ms": attn_row["kernel_ms"], "plain_ms": attn_row["plain_ms"],
        "bound_ms": attn_row["bound_ms"], "bound_by": attn_row["bound_by"],
        "library_ms": attn_row["library_ms"],
        "call_ms": attn_row["kernel_call_ms"],
        "probe_ms": attn_row["probe_ms"],
        "probe_bound_ms": attn_row["probe_bound_ms"],
        "shape": [attn_row[k] for k in ("B", "S", "H", "KV", "hd")],
        "window": attn_row["window"], "dtype": attn_row["dtype"],
        "check": attn_row["check"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
