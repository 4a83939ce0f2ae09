#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py [--phases convex,registry,mesh]

Run from the root of a checkout on a machine with a CUDA card (an H100:
the kernels are built for sm_90a).  Phases, in order; any failure ends
the script with a non-zero exit and no result line.  ``--phases`` runs
the named ones of ``PHASES`` (and what each needs) after the build, and
prints no kernels line; with no argument every phase runs:

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
    (flash_attention).  Each must also repeat its bits on a second call
    (B1 and B4, whose blocks meet through a per-call scratch, and B2 and
    B3, whose outputs the rematerialized LM steps compute twice).
 3. main paths — ``repro_torch.api.build(spec, device="cuda").run()``,
    each path with the launch counts zeroed just before it and read just
    after:
    a. convex: the quickstart spec (examples/quickstart.py) at scale 6,
       two-track then batch; linear_value_grad launches exactly once per
       optimizer step the traces imply (the race's WHILE graph counts its
       replays); one pull a stage; the WHILE graph launched once a racing
       stage; then (registry) a FixedSteps and a NewtonCG registered under
       new names (``register_policy``, ``register_optimizer``) and
       quickstart@6 built through a RunSpec naming them, bitwise the run
       under the built-in names, B1's launches the trace's count;
    a'. the convex method set on the same problem, each run a path of its
       own: two-track with nonlinear CG, L-BFGS and AdamW; the
       gradient-variance policy, alone and as a veto of two-track
       (Newton-CG); DSM; mini-batch Adagrad.  One line each (wall s,
       stages, steps, host transfers, launches against the trace's
       count), each held against the same run on the CPU (columns equal,
       f̂ within rtol 1e-4); then the reference benchmarks' method set
       (``repro_torch.launch.methods``) on its six fixtures;
    b. LM: falcon-mamba-7b at its full published width, depth cut to 4
       layers, two-track (launch/train.py's spec); ssm_scan launches
       num_layers times per forward pass the trace implies (a train step
       is two: its forward and the rematerialization in its backward);
       one host transfer a stage, each racing stage captured into a WHILE
       graph (its capture seconds); f̂ on the eval probe falls; one line
       per stage;
    c. hybrid LM: recurrentgemma-9b at its full published width, depth
       cut to one (rec, rec, attn) super-block, under fixed_steps
       (launch/train.py's default schedule) on sequences of 4,096 tokens,
       longer than its 2,048 local window; rglru_scan launches twice and
       flash_attention once per forward pass the trace implies (three a
       step: the train step's, its rematerialization, the f̂ probe's); f̂
       falls; one line per stage, the peak memory.
    For each LM, after its run: one full-width train step's loss and
    gradients with ``remat`` on, on again and off (the loss chunks are
    rematerialized either way, as in the reference), held bitwise, with
    each phase's peak memory; then a train step taken apart (forward,
    backward with the rematerialization timed apart from the kernels'
    plain VJPs, AdamW, each with its peak memory).  The checks of these
    and of phase 3a' fail the run at its end, after every line is out.
 4. card against CPU — the convex workload, and the reduced LMs (mamba
    and hybrid) in float32, under fixed_steps on the card and on the CPU
    (plain versions): clock and access columns equal, f̂ within rtol 1e-4.

The streaming data plane (``DataSpec(plane="plane")``: shard stores, a
prefetch thread and a window on the card that grows in place) carries
the LM main paths of 3b and 3c, as the reference trainer's default, and
has phases of its own, each run's launches counted from 0:
 3a". convex on the plane: quickstart@6 (768 shards of 64 rows),
    two-track and batch, each held bit for bit against the host path (f̂,
    the clock and access columns, transfers, the final w, B1's launches),
    with the meter's counters (every example loaded and uploaded once,
    accesses the clock's), its overlap and reuse and the stage walls;
    then BENCH_data.json's fig3 setting through a memmap store in a
    temporary directory, read with a 2 ms delay a shard.
 3b'/3c'. each LM main path's width and depth for two stages of two
    steps on the host path and on the plane: loss per stage, f̂, every
    column and the parameters' checksum held bitwise.
 3d. kill and resume: quickstart@6 two-track on the plane, and
    falcon-mamba-7b two-track at full width and one layer (one 6.4 GB
    checkpoint kept), each killed after stage 1 and resumed from its
    stage checkpoint by ``resume_session`` in a fresh session; the
    stitched run held bitwise against an uninterrupted one, the rewarm
    record the stage's window; the checkpoint's bytes and write and read
    seconds.  The checkpoints go to a temporary directory under build/,
    deleted at the end.

The multi-host runtime (``TopologySpec(hosts=4)``: four simulated hosts
whose lanes share the card, each host's plane reading only its owned
shards) and elastic recovery, each check failing the run at its end:
 3e. convex over 4 hosts: quickstart@6 two-track, B1 launched once per
    non-empty lane per step as the trace and the lane counts imply, the
    reference benchmark's claims (each host loads its owned slice, each
    example leaves storage once, no resident byte re-uploaded, one
    collective flush a stage), the same run on the CPU within rtol 1e-4;
    at hessian_fraction 1 against one host (f̂ within rel 1e-3, the same
    host transfers); BENCH_dist.json's setting (fig3 webspam_like 2,048 ×
    1,024, memmap shards of 128 rows, 1 ms a read).
 3f. elastic, on the same 4-host quickstart@6 run: a host killed after
    stage 1, bit for bit the unfaulted run, re-reading exactly its lane's
    owned slice of the window; a straggler whose reads take 0.2 s against
    a 0.02 s flush deadline (shards migrated, each example loaded once,
    the windows a partition, f̂ within rel 1e-3 of the unfaulted run); a
    kill-and-resume from a "distributed" stage checkpoint, bit for bit.
 3g. the LMs over 4 hosts, two stages of two steps: falcon-mamba-7b at
    full width and one layer (8 × 256, two rows a lane), unfaulted and
    with host 1 killed after stage 0, bit for bit; recurrentgemma-9b, one
    super-block (4 × 4096, a row a lane); B3, B4 and B2 launched as the
    traces imply, each peak (above the memory held before its build)
    within 100 MB of the same run on one host.
 3h. a one-process ProcessTopology over NCCL: all-reduce, all-gather, and
    a DistributedDataset under it bit for bit the simulated one-host one.

The transformer and moe families (``impl="xla"``: plain PyTorch layers,
no kernel, as in the reference), each check failing the run at its end:
 3i. qwen3-0.6b (dense, qk-norm) two-track and granite-moe-1b-a400m (32
    experts, top-8) under fixed_steps, each at its full published width
    and depth, on the plane: one line per stage, the run's peak memory,
    no launch of B1-B4; a train step with remat on, on again and off held
    bitwise; the step taken apart (forward, backward, AdamW, each with
    its peak; the moe aux terms).
 3j. the rest of the zoo at full width and one layer (internlm2-1.8b,
    yi-9b, stablelm-12b, musicgen-medium, llama4-scout-17b-a16e,
    qwen2-vl-2b with random embeds and M-RoPE positions): loss_fn and its
    gradients at 1 x 512, finite, with ms and peak memory.
 3k. BENCH_workloads.json's eleven presets through the port's sweep
    (``repro_torch.workloads.sweep``, each observed in a temporary
    directory), each with the reference sweep's claims (the mamba and
    rglru presets kernel-routed, the serve preset's closed loop and the
    obs preset among them); ``matrix_green`` must hold.
 4 also holds the reduced qwen3-0.6b and granite-moe-1b-a400m to the CPU.

Serving (``models/transformer.py``'s prefill and decode, ``repro_torch.
serve``), each check failing the run at its end:
 3l. recurrentgemma-9b, one super-block at full width, 4 prompts of 2,560
    tokens (past the 2,048 local window): prefill with impl="xla" and
    "pallas" (B2 once a prefill, B4 never: the reference's prefill runs
    the Griffin block's plain loop), logits within 0.03; one decode step
    against a pallas prefill of 2,561 tokens within 0.03 (the reference
    test's bound); 32 greedy decode steps on the wrapped ring.
    qwen3-0.6b at full width and depth: ``launch/serve.generate``, 8 x 64
    prompts, 64 tokens: decode ms a token, tokens/s, peak.  One
    full-width layer each of falcon-mamba-7b and granite-moe-1b-a400m
    (capacity factor 8): decode against prefill, float32 within 1e-4 and
    bfloat16 within 0.03.
 3m. the closed loop (``serve.build_loop``) on falcon-mamba-7b at full
    width and one layer: ticks, requests, stages, holds, the server's
    swaps and tokens/s, the warm staleness, the meter, each stage's
    checkpoint write; B3 launched 3 x steps (forward, rematerialization,
    probe); BENCH_serve.json's claims that need no A/B and its resume
    contract (the final params bitwise, the clock exact, the meters).
 3m'. BENCH_serve.json's A/B on its setting (qwen3-0.6b reduced): all
    seven claims, throughput under swap >= 0.8 of no swap.
 4 also holds the reduced hybrid's prefill and decode logits, and a
    reduced closed loop's counts and logged tokens, to the CPU.

The race on the device and observability (C4, A11), right after 3a:
 3n. quickstart@6 two-track (3a's run) against the same run with the
    plain loop on the card (bitwise: trace, final w, trigger steps) and
    against the CPU (columns equal, f̂ within 1e-4); its longest racing
    stage alone, the WHILE graph's launch against the plain loop from the
    same carry (CUDA events, max_abs_err, capture ms, the loop's bound);
    BENCH_engine.json's ``engine_max_one_transfer_per_stage`` at its own
    setting (fig3 webspam_like at scale 0.25; bet_fixed, two-track,
    batch).  3e and 3i add one pull a stage over 4 hosts and for qwen3.
 3o. quickstart@6 two-track on the plane under ObsSpec(enabled, dir,
    chrome_trace, profile, health): the RunReport's claims all true, the
    run bitwise the unobserved one, one ``profile.stage`` a stage (FLOPs,
    bytes, roofline seconds at the H100's peaks) beside the stage's
    compute seconds; BENCH_dist.json's setting under fleet and health obs
    at 4 hosts: a lane file a host, the merged trace causal at every
    barrier, health's detections.  Each new phase prints its seconds.

The tiered corpus (A11 ``data/tiers/``: a hot window under an HBM byte
budget over a pinned host ring over shard stores), its checks failing
the run at its end:
 3p. w8a_like's width at 2^22 rows (5.05 GB, 256 shards of 16,384 rows
    in a memory store) under ``TieringSpec(hbm_bytes=corpus / 4)``:
    Newton-CG, fixed_steps 200/800 from n0 2^16, growth 2, observed.
    One line: the wall, ``tier_report()`` and both meters, B1's launches
    beside the count the trace implies, ``max_memory_allocated`` beside
    the hot window and one staged segment and the step's workspace, the
    synchronizes inside the commits (none), and BENCH_scale.json's twelve
    claims (bench_scale.py's definitions, kept here), all of which must
    hold.  Then the same corpus with the whole of it in the budget,
    bitwise the untiered plane (f̂ on the window, the columns, the final
    w), and a kill-and-resume of a rotating run at 2^18 rows, bitwise the
    uninterrupted one; the phase's seconds.

The launch tooling (A12: DTensor layouts over a ``DeviceMesh``), right
after 3h's group is gone, its checks failing the run at its end:
 3q. (a) the dry run (``launch/dryrun.py``) of qwen3-0.6b at full width
    and depth on the 16×16 fake world: ``train_4k`` under ``fsdp_tp`` and
    ``decode_32k`` under ``tp``, one line each (FLOPs, bytes and wire
    bytes a device, the three roofline terms at the H100's peaks, the
    bottleneck, ``trace_s``; the train step's top 5 collective sites; the
    torch version, since DTensor's layouts change with it); no operation
    of ``attention.py`` may run replicated, and the train step's count
    must stay under 3x the model's 6·N·D share.
    (b) one train step of qwen3-0.6b at full width and all 28 layers on
    the 3i batch (8 × 1,024) with DTensor parameters on a (1, 1) CUDA mesh
    of a one-rank NCCL group under ``fsdp_tp+act``, against the port's
    plain train step on the same parameters and batch: loss, gradient
    norm and every updated leaf bitwise, or within 1e-6 relative with
    each leaf's error printed; both steps' times (first and second call);
    the dry run's per-device memory for the same step beside
    ``max_memory_allocated``; nothing of ``attention.py`` replicated.
    Every line carries the card's name and power limit.

The pre-engine host loops (``core/legacy.py``) against the engine, right
after 3n, its checks failing the run at its end:
 3r. (a) quickstart@6 (3a's problem, Newton-CG at R 0.2, n0 128):
    ``legacy.run_bet_fixed`` (inner 4, final 8), ``run_two_track`` (final
    8) and ``run_batch`` (10 steps), each against the port's deprecated
    wrapper of the same name, that is the engine: the columns and the
    (stage, window) sequence equal, f̂, f̂ on the full set and the fast
    track's f̂ within 1e-5 (the reference test's bound); B1's launches in
    each run the count its trace implies; the loop's host pulls what its
    trace implies (two a step, three a racing step and one a final step,
    one a recorded step).  (b) BENCH_engine.json's comparison at its own
    setting (bench_engine.py's definitions, kept here): bet_fixed,
    two_track and batch, each legacy loop against ``run_method`` after
    one warm-up run each: one line a method (both walls, both host-sync
    counts, syncs per inner step and per stage, the speedup, parity), then
    the four claims, of which all but ``engine_faster`` (a comparison of
    wall seconds) must hold.  Every line carries the card's name and power
    limit; the last the phase's seconds.

Then the ``{"kernels": [...]}`` line (B1–B4 and the WHILE graph), and
last ``{"ok": true, ...}``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# outside the tensor cores, dense bfloat16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12
PEAK_BF16_FLOPS_S = 989e12

# Kernel check tolerance against the float64 plain version.  The kernel
# accumulates in float32: per-lane partials over a row group's rows, the
# groups and warps of a block in a fixed order, then a two-level
# fixed-order sum over at most one block partial an SM.  Rounding grows
# like sqrt(terms) x 6e-8, i.e. ~1e-6 relative at n = 4M; 1e-5 on L and
# 1e-4 on g leave an order of magnitude of room and still catch a dropped
# row, a wrong loss branch or a racy reduction (all far above 1e-3).
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
# (label, n, d, how the data is made: a loaded set's first n rows, or
# random); Adagrad's mini-batch and a DSM sample have the main path's width
KERNEL_SHAPES = [
    ("w8a_like@6", 49152, 300, ("load", "w8a_like", 6.0)),
    ("adagrad_batch", 64, 300, ("load", "w8a_like", 6.0)),
    ("dsm_sample", 512, 300, ("load", "w8a_like", 6.0)),
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
# train step gives it, the second its f̂ probe; "ragged" is shorter than
# one of the kernel's 256-step chunks, "ragged_chunks" has three whole
# chunks and a ragged fourth, with W not a multiple of a 16-byte vector of
# bfloat16 (the kernel's element-at-a-time path)
RGLRU_SHAPES = [
    ("recurrentgemma-9b", HY_BATCH, HY_SEQ, HY_WIDTH,
     ("bfloat16", "float32")),
    ("probe", HY_EVAL_ROWS, HY_SEQ, HY_WIDTH, ("bfloat16",)),
    ("ragged", 3, 77, HY_WIDTH + 40, ("bfloat16", "float32")),
    ("ragged_chunks", 3, 1000, HY_WIDTH + 4, ("bfloat16", "float32")),
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


# the streaming plane's phases.  BENCH_data.json's fig3 setting (the
# reference's bench_data.py): webspam_like at scale 0.25 (4,096 x 1,024),
# shards of 256 rows in a memmap store read with a 2 ms delay each,
# fixed_steps (5, 25), n0 512, Newton-CG on half the window
MEMMAP_DATA = dict(dataset="webspam_like", scale=0.25, shard_size=256,
                   delay_ms=2.0)
MEMMAP_N0, MEMMAP_STEPS, MEMMAP_HESSIAN = 512, (5, 25), 0.5
# the LMs' plane-against-host runs: two stages of two steps at the main
# paths' widths and depths (n0 half the corpus)
SHORT_STEPS = (2, 2)
# the LM kill-and-resume: falcon-mamba-7b at full width and one layer,
# two-track over 256 sequences (two racing stages and the final phase),
# killed after stage 1; one checkpoint kept on disk
RESUME_LAYERS, RESUME_CORPUS, RESUME_N0, RESUME_ITERS = 1, 256, 64, 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# checks that fail the run at its end, after every phase has printed its
# lines (each is also printed where it fails)
FAILED: list = []


def fail_later(message: str) -> None:
    emit({"check_failed": message})
    FAILED.append(message)


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
    # outlasts the enqueue with room: a few-microsecond kernel's 30 calls
    # enqueue in ~1 ms, and the host's jitter can triple that
    spin_s = 4.0 * host_s + 0.05
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
            X, y = ds.X[:n], ds.y[:n]
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
            L2, g2 = lg.linear_value_grad(X, y, w, loss=loss)
            torch.cuda.synchronize()
            repeat = torch.equal(L, L2) and torch.equal(g, g2)
            L64, g64 = ref.linear_value_grad(X64, y64, w64, loss=loss)
            err_L = abs(float(L) - float(L64))
            err_g = float((g.double() - g64).abs().max())
            g_scale = max(1.0, float(g64.abs().max()))
            ok = (math.isfinite(float(L)) and bool(torch.isfinite(g).all())
                  and err_L <= RTOL_L * abs(float(L64))
                  and err_g <= TOL_G * g_scale and repeat)
            fns = {"kernel": lambda: lg.linear_value_grad(X, y, w, loss=loss),
                   "plain": lambda: ref.linear_value_grad(X, y, w, loss=loss),
                   "library": lambda: library_pair(torch, X, y, w, loss)}
            row = {"kernel": "linear_value_grad", "shape": label, "n": n,
                   "d": d, "loss": loss, "err_L": err_L,
                   "rel_err_L": err_L / abs(float(L64)), "err_g": err_g,
                   "rel_err_g": err_g / g_scale, "repeat_bitwise": repeat,
                   **bounds_ms(n, d), "check": "pass" if ok else "FAIL"}
            for k, f in fns.items():
                t = time_ms(torch, f, spin_rate)
                row[f"{k}_ms"], row[f"{k}_call_ms"] = t["ms"], t["call_ms"]
            emit(row)
            if not ok:
                raise SystemExit(f"linear_value_grad disagrees with its "
                                 f"float64 plain version, or with itself on "
                                 f"a repeat, at {label}/{loss}")
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
            differ = int((y != ops.ssm_scan(*args)).sum())
            torch.cuda.synchronize()
            y64 = ref.ssm_scan(*(a.double() for a in args))
            err = (y.double() - y64).abs()
            max_abs = float(err.max())
            rel = float((err / (1.0 + y64.abs())).max())
            ok = (bool(torch.isfinite(y).all()) and rel <= SCAN_TOL[dname]
                  and differ == 0)
            row = {"kernel": "ssm_scan", "shape": label, "B": B, "S": S,
                   "di": di, "N": N, "dtype": dname, "max_abs_err": max_abs,
                   "max_rel_err": rel, "tol": SCAN_TOL[dname],
                   "repeat_bitwise": differ == 0, "repeat_differ": differ,
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
                                 f"version ({rel}), or with itself on a "
                                 f"repeat ({differ} elements), at "
                                 f"{label}/{dname}")
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
    rows = {}
    for label, B, S, W, dnames in RGLRU_SHAPES:
        for dname in dnames:
            a, b = rglru_inputs(torch, gen, B, S, W, getattr(torch, dname))
            y = ops.rglru_scan(a, b)
            repeat = torch.equal(y, ops.rglru_scan(a, b))
            torch.cuda.synchronize()
            y64 = ref.rglru_scan(a.double(), b.double())
            err = (y.double() - y64).abs()
            max_abs = float(err.max())
            rel = float((err / (1.0 + y64.abs())).max())
            del y64, err
            ok = (bool(torch.isfinite(y).all()) and rel <= RGLRU_TOL[dname]
                  and repeat)
            row = {"kernel": "rglru_scan", "shape": label, "B": B, "S": S,
                   "W": W, "dtype": dname, "max_abs_err": max_abs,
                   "max_rel_err": rel, "tol": RGLRU_TOL[dname],
                   "repeat_bitwise": repeat,
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
                                 f"plain version ({rel}), or with itself on "
                                 f"a repeat ({repeat}), at {label}/{dname}")
            if dname == "bfloat16":
                rows[label] = row
            del a, b, y
    return rows


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
        differ = int((o != ops.flash_attention(q, k, v, causal=True,
                                               window=window)).sum())
        torch.cuda.synchronize()
        o64 = attention64(torch, ref, q, k, v, window)
        err = (o.double() - o64).abs()
        max_abs = float(err.max())
        rel = float((err / (1.0 + o64.abs())).max())
        del o64, err
        ok = (bool(torch.isfinite(o).all()) and rel <= ATTN_TOL[dname]
              and differ == 0)
        row = {"kernel": "flash_attention", "shape": label, "B": B, "S": S,
               "H": H, "KV": KV, "hd": hd, "window": window, "dtype": dname,
               "max_abs_err": max_abs, "max_rel_err": rel,
               "tol": ATTN_TOL[dname], "repeat_bitwise": differ == 0,
               "repeat_differ": differ,
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
                             f"plain version ({rel}), or with itself on a "
                             f"repeat ({differ} elements), at {label}")
        if label == ATTN_SHAPES[0][0]:
            main = row
        if label == "probe":
            main["probe_ms"] = row["kernel_ms"]
            main["probe_bound_ms"] = row["bound_ms"]
        del q, k, v, o
        torch.cuda.empty_cache()
    return main


def quickstart_specs(api, scale: float = 6.0):
    data = api.DataSpec(dataset="w8a_like", scale=scale, lam=1e-3)
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
    # two launches per race step, one per final-phase and batch step (the
    # race stops at its trigger: no step runs past it)
    overshoot = sum(tr.meta["race_overshoot"] for tr in traces.values())
    implied = sum(rt["methods"].kernel_calls(tr) for tr in traces.values())
    rt["main_two_track"] = {"session": sessions["two_track"],
                            "trace": traces["two_track"],
                            "wall_s": walls["two_track"]}
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
            row["capture_s"] = list(sess.engine.race_capture_s)
        emit(row)
        if not finite(tr):
            raise SystemExit(f"{name}: non-finite values in the trace")
        if tr.meta["host_transfers"] != tr.meta["stages"] or \
                tr.meta["race_overshoot"]:
            raise SystemExit(f"{name}: {tr.meta['host_transfers']} pulls "
                             f"over {tr.meta['stages']} stages, overshoot "
                             f"{tr.meta['race_overshoot']}: the race must "
                             f"pull once a stage")
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
    racing = traces["two_track"].meta["stages"] - 1
    if launches.get("device_while", 0) != racing:
        raise SystemExit(f"the race's WHILE graph launched "
                         f"{launches.get('device_while', 0)} times over "
                         f"{racing} racing stages")
    rt["main_two_track"]["device_while"] = launches["device_while"]
    return launches["linear_value_grad"]


# the names the registry phase registers the built-ins under
REGISTERED = {"fixed_steps": "fixed_steps_registered",
              "newton_cg": "newton_cg_registered"}


def registry_phase(torch, rt, scale: float = 6.0,
                   device: str = "cuda") -> dict:
    """3a (registry): a FixedSteps and a NewtonCG registered under new
    names (``register_policy``, ``register_optimizer``), quickstart@6
    built through a RunSpec naming them, against the same spec under the
    built-in names: every column, f̂ and the final w bitwise; B1's
    launches in the registered run (counted from 0) the count its trace
    implies.  The registrations are taken out at the end."""
    api, ops = rt["api"], rt["ops"]
    from repro_torch.core.engine import FixedSteps
    from repro_torch.optim import NewtonCG
    _, base = quickstart_specs(api, scale)
    params = {"inner_steps": 4, "final_steps": 8}

    def spec(policy, optimizer):
        return api.RunSpec(**{**base, "optimizer": api.OptimizerSpec(
            optimizer, base["optimizer"].params)},
            policy=api.PolicySpec(policy, params))

    api.register_policy(REGISTERED["fixed_steps"], FixedSteps)
    api.register_optimizer(REGISTERED["newton_cg"], NewtonCG)
    try:
        builtin = api.build(spec("fixed_steps", "newton_cg"),
                            device=device).run()
        sess = api.build(spec(*REGISTERED.values()), device=device)
        sync(torch, device)
        ops.reset_calls()
        t0 = time.perf_counter()
        tr = sess.run()
        sync(torch, device)
        wall = time.perf_counter() - t0
        launches = ops.CALLS.get("linear_value_grad", 0)
    finally:
        api.POLICIES._entries.pop(REGISTERED["fixed_steps"], None)
        api.OPTIMIZERS._entries.pop(REGISTERED["newton_cg"], None)
    diff = bitwise_diff(run_record(tr), run_record(builtin))
    same_w = bool(torch.equal(tr.params, builtin.params))
    implied = rt["methods"].kernel_calls(tr)
    row = {"path": "convex_registered", "names": REGISTERED,
           "steps": len(tr.points), "stages": tr.meta["stages"],
           "bitwise": not diff and same_w, "differs": diff,
           "launches": launches, "launches_implied": implied,
           "wall_s": wall, "card": rt.get("smi", device)}
    emit(row)
    if diff or not same_w:
        fail_later(f"registered names against built-in names: {diff}, "
                   f"final w equal {same_w}")
    if launches != implied:
        fail_later(f"registered run: linear_value_grad launched {launches} "
                   f"times, the trace implies {implied}")
    return row


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


def method_runs(rt, scale: float = 6.0) -> dict:
    """The convex method set on quickstart@6 (49,152 x 300; ``scale``
    sets another size): name -> run(device) -> trace.  Two-track with the
    other inner optimizers (AdamW at lr 0.01: the reference's default
    3e-4 barely moves a convex problem), the gradient-variance policy
    (its defaults: θ 0.5, probe 256) alone and as a veto of two-track,
    with quickstart's Newton-CG; DSM and mini-batch Adagrad with the
    reference benchmarks' settings (``run_method``: θ 0.2, 30 DSM steps
    from 300 rows; 1,200 Adagrad steps of 64 rows at lr 0.5)."""
    api, methods = rt["api"], rt["methods"]
    data, base = quickstart_specs(api, scale)
    two_track = api.PolicySpec("two_track", {"final_steps": 20})

    def spec(policy, optimizer=base["optimizer"]):
        s = api.RunSpec(policy=policy, **dict(base, optimizer=optimizer))
        return lambda device: api.build(s, device=device).run()

    def baseline(method):
        def run(device):
            ds, objective, w0 = api.convex_problem(data, device=device)
            return methods.run_method(method, ds, objective, w0)
        return run

    return {
        "two_track/cg": spec(two_track, api.OptimizerSpec("cg")),
        "two_track/lbfgs": spec(two_track, api.OptimizerSpec("lbfgs")),
        "two_track/adamw": spec(two_track,
                                api.OptimizerSpec("adamw", {"lr": 0.01})),
        "gradient_variance/newton_cg": spec(
            api.PolicySpec("gradient_variance", {"final_steps": 20})),
        "two_track+gradient_variance/newton_cg": spec(api.PolicySpec(
            "two_track", {"final_steps": 20},
            veto=(api.PolicySpec("gradient_variance"),))),
        "dsm/newton_cg": baseline("dsm"),
        "minibatch/adagrad": baseline("adagrad"),
    }


def convex_methods_phase(torch, rt) -> int:
    """Each run of ``method_runs`` on the card, its linear_value_grad
    launches counted from 0 and held to the calls its trace implies, then
    the same run on the CPU: the step, stage, window, clock and access
    columns and the host transfers equal, f̂ at every point within
    RTOL_F.  Then ``repro_torch.launch.methods``' set on the card, each
    run's launches held likewise.  Returns the launches of the runs."""
    ops, methods = rt["ops"], rt["methods"]
    total = 0
    for name, run in method_runs(rt).items():
        torch.cuda.synchronize()
        ops.reset_calls()
        t0 = time.perf_counter()
        gpu = run("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.CALLS["linear_value_grad"]
        implied = methods.kernel_calls(gpu)
        t0 = time.perf_counter()
        cpu = run("cpu")
        cpu_wall = time.perf_counter() - t0
        cols = ("step", "stage", "window", "time", "accesses")
        equal = [c for c in cols if gpu.column(c) != cpu.column(c)]
        f_gpu = np.array(gpu.column("f_full"))
        f_cpu = np.array(cpu.column("f_full"))
        rel = (float(np.max(np.abs(f_gpu - f_cpu) / np.abs(f_cpu)))
               if len(f_gpu) == len(f_cpu) else float("inf"))
        stages = gpu.column("stage")
        row = {"path": "convex_methods", "run": name,
               "stages": len(set(stages)),
               "steps_per_stage": [stages.count(s)
                                   for s in sorted(set(stages))],
               "steps": gpu.final().step + 1,
               "host_transfers": gpu.meta["host_transfers"],
               "race_overshoot": gpu.meta.get("race_overshoot", 0),
               "linear_value_grad_launches": launches,
               "implied_launches": implied, "wall_s": wall,
               "sim_time": gpu.final().time,
               "data_accesses": gpu.final().accesses,
               "f_full": gpu.final().f_full, "cpu_wall_s": cpu_wall,
               "columns_differ": equal, "max_rel_f_full": rel,
               "cpu_host_transfers": cpu.meta["host_transfers"]}
        emit(row)
        if not finite(gpu):
            fail_later(f"{name}: non-finite values in the trace")
        if launches != implied:
            fail_later(f"{name}: linear_value_grad launched {launches} "
                       f"times, the trace implies {implied}")
        if equal or not rel <= RTOL_F or \
                gpu.meta["host_transfers"] != cpu.meta["host_transfers"]:
            fail_later(f"{name}: card and CPU differ (columns {equal}, "
                       f"f_full rel {rel} against {RTOL_F}, transfers "
                       f"{gpu.meta['host_transfers']} and "
                       f"{cpu.meta['host_transfers']})")
        total += launches
    for row in methods.run_set("cuda"):
        launches = ops.CALLS["linear_value_grad"]     # counted from 0
        emit({"path": "methods", **row})
        if launches != row["kernel_calls_implied"] \
                or not math.isfinite(row["f_full"]):
            fail_later(f"methods {row['fixture']}/{row['method']}: "
                       f"{launches} launches against "
                       f"{row['kernel_calls_implied']} implied, "
                       f"f_full {row['f_full']}")
    return total


def lm_spec(api, *, arch: str = "falcon-mamba-7b", reduced: bool, policy,
            corpus: int, seq_len: int, n0: int,
            max_stage_iters: int | None = None,
            layers: int | None = LM_LAYERS, batch: int = LM_BATCH,
            eval_rows: int = 16, fixed: tuple = (3, 3),
            plane: str = "plane"):
    """The trainer's LM RunSpec (``launch/train.py``'s ``to_run_spec``):
    the streaming plane by default (the trainer's ``use_plane=True``;
    shards of 64 sequences), adamw_lm at lr 3e-4, a batch-cost clock that
    waits on expansion and carries the Adam moments across stages;
    ``policy`` "two_track" (8 final steps) or "fixed_steps" (``fixed``:
    steps a stage, final steps).  The full config cut to ``layers`` (all
    of them when None), or the reduced one in float32."""
    from repro_torch import configs
    from repro_torch.launch import train
    two_track = policy == "two_track"
    tc = train.TrainConfig(
        schedule="two_track" if two_track else "bet", batch_size=batch,
        seq_len=seq_len, n0=n0, corpus_size=corpus, inner_steps=fixed[0],
        final_steps=8 if two_track else fixed[1], lr=3e-4,
        max_stage_steps=max_stage_iters, eval_rows=eval_rows,
        use_plane=plane == "plane")
    cfg = configs.get(arch)
    spec = train.to_run_spec(configs.reduced(cfg) if reduced else cfg, tc)
    if reduced:
        overrides = {"dtype": "float32"}
    else:
        overrides = {} if layers is None else {"num_layers": layers}
    return spec.replace(model=spec.model.replace(overrides=overrides))


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
    # final step: a train step, plus f̂ when final_eval_full.  A train
    # step is two forward passes: its own and, in its backward, the
    # rematerialization of every layer.  The race stops at its trigger
    # (overshoot 0), and the WHILE graph's replays are counted by
    # ops.finish_race_loop
    race_evals = 3 if pol.condition == "eval" else 2
    final_evals = 1 if pol.final_eval_full else 0
    train_steps = 2 * race + final
    evals = race_evals * race + final_evals * final
    implied = cfg.num_layers * (2 * train_steps + evals)
    values = (tr.column("f_window") + tr.column("f_full")
              + [p.extra["f_fast_on_t"] for p in tr.points
                 if "f_fast_on_t" in p.extra])
    summary = {"path": "lm", "stages": tr.meta["stages"],
               "race_steps": race, "final_steps": final,
               "race_overshoot": overshoot,
               "capture_s": list(sess.engine.race_capture_s),
               "captures": sum(c > 0 for c in sess.engine.race_capture_s),
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
    # the race pulls once a racing stage, as the reference's while loop
    for r in rows:
        if r["host_transfers"] != 1:
            raise SystemExit(f"stage {r['stage']} of {r['steps']} steps "
                             f"took {r['host_transfers']} transfers")
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


def recompute_timer(sync):
    """A ``context_fn`` for the model's rematerialized regions
    (``transformer.REMAT_CONTEXT``) that times each region's
    recomputation inside the backward on the host clock, ended by
    ``sync``; returns it with the totals it fills ({"s", "regions"})."""
    totals = {"s": 0.0, "regions": 0}

    @contextlib.contextmanager
    def recomputing():
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            totals["s"] += time.perf_counter() - t0
            totals["regions"] += 1

    return (lambda: (contextlib.nullcontext(), recomputing())), totals


def hook_vjps(loss, node_names: dict, seg: dict, sync, recompute) -> list:
    """A pre-hook and a hook on each node of ``loss``'s autograd graph
    named in ``node_names`` ({part: node name}): each node's time in the
    backward, from the pre-hook to the hook, both ended by ``sync``, less
    the recomputation that ran inside it (``recompute``, the totals of
    ``recompute_timer``), adds to ``seg["<part>_vjp_in_backward_s"]``;
    ``seg["<part>_vjp_nodes"]`` counts the nodes that ran.  Returns the
    handles."""
    handles = []
    for node in graph_nodes(loss):
        for part, node_name in node_names.items():
            if node.name() != node_name:
                continue
            start = []

            def pre(_, start=start):
                sync()
                start.append((time.perf_counter(), recompute["s"]))

            def post(_, __, part=part, start=start):
                sync()
                t0, r0 = start.pop()
                key = f"{part}_vjp_in_backward_s"
                seg[key] = seg.get(key, 0.0) + time.perf_counter() - t0 \
                    - (recompute["s"] - r0)
                seg[f"{part}_vjp_nodes"] = seg.get(f"{part}_vjp_nodes", 0) + 1

            handles += [node.register_prehook(pre), node.register_hook(post)]
    return handles


def remat_regions(cfg, seq_len: int) -> int:
    """The regions a train step rematerializes: each layer of a
    homogeneous stack or each whole super-block of a hybrid, and each
    cross-entropy chunk (of 512 tokens, or the sequence if shorter)."""
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        blocks = cfg.num_layers // len(pat)
    else:
        blocks = cfg.num_layers
    return blocks + seq_len // min(512, seq_len)


def step_breakdown(torch, rt, sess, params, batch_size: int, path: str,
                   parts: dict, impl: str = "pallas") -> dict:
    """Where a train step's time and memory go: host-clock segments, each
    ended by a synchronize, of one step taken apart (forward with the
    graph, the backward, the AdamW update), one f̂ probe, and each
    kernel's share of the forward and of the backward; the peak memory of
    the forward, the backward and the update, each read after its own
    ``reset_peak_memory_stats``.  ``parts`` maps a name to (inputs, kernel
    call, calls per step, its autograd node's name): the kernel forward is
    timed alone at the path's shape; its plain-version VJP is timed inside
    the step's backward by hooks on each of its nodes, and the
    rematerialization of each region inside the backward is timed apart
    and taken out of the VJP that holds it (``hook_vjps``).  ``impl`` is
    the family's layer implementation; the line carries the loss's
    metrics (a moe stack's aux terms too).  Taken after the main path's
    counts were read; the launches here are not counted there."""
    T, adam, tree_map = rt["transformer"], rt["adam"], rt["tree_map"]
    cfg = sess.model_config
    rows = first_rows(rt, sess, batch_size)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    opt_state = adam.adamw_init(params)
    seg = {}
    sync = torch.cuda.synchronize

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        seg[name] = seg.get(name, 0.0) + time.perf_counter() - t0
        return out

    def peak(name):
        seg[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    node_names = {name: v[3] for name, v in parts.items()}
    saved_context = T.REMAT_CONTEXT
    for rep in range(2):                # the first is a warm-up
        seg.clear()
        context_fn, recompute = recompute_timer(sync)
        T.REMAT_CONTEXT = context_fn
        try:
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            with torch.enable_grad():
                torch.cuda.reset_peak_memory_stats()
                loss, metrics = timed("forward_s", lambda: T.loss_fn(
                    cfg, p, batch, impl=impl))
                peak("forward")
                leaves = rt["tree_leaves"](p)
                handles = hook_vjps(loss, node_names, seg, sync, recompute)
                torch.cuda.reset_peak_memory_stats()
                flat = timed("backward_s",
                             lambda: torch.autograd.grad(loss, leaves))
                peak("backward")
                for h in handles:
                    h.remove()
        finally:
            T.REMAT_CONTEXT = saved_context
        seg["recompute_in_backward_s"] = recompute["s"]
        seg["recompute_regions"] = recompute["regions"]
        it = iter(flat)
        grads = tree_map(lambda _: next(it), p)
        del p, loss, flat
        metrics = {k: v.detach() for k, v in metrics.items()}
        torch.cuda.reset_peak_memory_stats()
        timed("adamw_s", lambda: adam.adamw_update(
            params, grads, opt_state, lr=3e-4, weight_decay=0.1))
        peak("adamw")
        del grads
        timed("probe_s", lambda: sess.objective(params, sess.eval_data))
        for name, (inputs, call, _, _) in parts.items():
            args = [a.requires_grad_(True) for a in inputs()]
            timed(f"{name}_forward_s", lambda: call(*args))
            del args
    out = {"path": path, "breakdown": "one train step", **seg,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "layers": cfg.num_layers,
           "recompute_share_of_backward":
               seg["recompute_in_backward_s"] / seg["backward_s"]}
    regions = remat_regions(cfg, batch["tokens"].shape[1])
    if seg["recompute_regions"] != regions:
        fail_later(f"{path} breakdown: {seg['recompute_regions']} regions "
                   f"recomputed in the backward, the model has {regions}")
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


def leaf_names(tree, prefix: str = "") -> list:
    """The paths of a nested dict's leaves, in ``tree_leaves`` order."""
    out = []
    for k, v in tree.items():
        out += leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) \
            else [prefix + k]
    return out


def remat_bitwise(torch, rt, sess, params, batch_size: int,
                  path: str, impl: str = "pallas") -> dict:
    """One full-width train step's loss and gradients from ``params`` on
    the path's first batch with ``remat`` on, on again, and off: the
    second run with remat and the run without are each held bitwise
    against the first (the differing elements counted by leaf otherwise).
    The host-clock time and the peak memory of each forward and backward
    are read after their own ``reset_peak_memory_stats``; the parameters
    and the first run's gradients are alive throughout."""
    T, tree_map = rt["transformer"], rt["tree_map"]
    cfg = sess.model_config
    rows = first_rows(rt, sess, batch_size)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    names = leaf_names(params)
    out = {"path": path, "check": "remat_on_against_off"}
    first = None
    for key, remat in (("remat_on", True), ("remat_on_again", True),
                       ("remat_off", False)):
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        with torch.enable_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = T.loss_fn(cfg, p, batch, impl=impl, remat=remat)[0]
            torch.cuda.synchronize()
            out[f"{key}_forward_s"] = time.perf_counter() - t0
            out[f"{key}_forward_peak_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            grads = torch.autograd.grad(loss, rt["tree_leaves"](p))
            torch.cuda.synchronize()
            out[f"{key}_backward_s"] = time.perf_counter() - t0
            out[f"{key}_backward_peak_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
        del p
        if first is None:
            first = (loss.detach(), grads)
            out.update(loss=float(first[0]), gradient_elements=sum(
                g.numel() for g in grads))
        else:
            differ = {n: int((a != b).sum())
                      for n, a, b in zip(names, first[1], grads)}
            out[f"{key}_loss_equal"] = torch.equal(first[0], loss)
            out[f"{key}_elements_differ"] = sum(differ.values())
            out[f"{key}_leaves_differ"] = {n: c for n, c in differ.items()
                                           if c}
        del loss, grads
    emit(out)
    for key in ("remat_on_again", "remat_off"):
        if not out[f"{key}_loss_equal"] or out[f"{key}_elements_differ"]:
            fail_later(f"{path}: {key} differs from remat_on (loss equal "
                       f"{out[f'{key}_loss_equal']}, gradient elements "
                       f"{out[f'{key}_leaves_differ']})")
    del first
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_step_breakdown(torch, rt, sess, params) -> None:
    cfg = sess.model_config
    gen = torch.Generator(device="cuda").manual_seed(2)
    parts = {"scan": (lambda: scan_inputs(torch, gen, LM_BATCH, LM_SEQ,
                                          cfg.d_inner, cfg.ssm_state,
                                          cfg.dtype),
                      rt["ops"].ssm_scan, cfg.num_layers,
                      "_SSMScanBackward")}
    remat_bitwise(torch, rt, sess, params, LM_BATCH, "lm")
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
    # fixed_steps: a train step (its forward pass and the
    # rematerialization of its super-block in its backward) and an f̂
    # probe (eval_full) per step
    passes = 3 * len(tr.points)
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
    summary["remat"] = remat_bitwise(torch, rt, sess, params, HY_BATCH,
                                     "hybrid")
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


def first_rows(rt, sess, k: int):
    """The first ``k`` rows of a session's corpus, from either data path
    (a host-path slice or the plane's MaskedWindow)."""
    rows, _ = rt["window_rows"](sess.dataset.window(k))
    return rows[:k]


def checksum(torch, rt, params) -> list:
    """One integer a leaf: the leaf's bits as integers, each times
    (its index mod 65,521) + 1, summed in int64 (wrapping); equal lists
    mean equal parameters but for a collision.  In chunks, so the
    hybrid's 1.05 G-element embedding needs no 8 GB temporaries."""
    out = []
    for x in rt["tree_leaves"](params):
        bits = x.detach().contiguous().reshape(-1).view(
            torch.int16 if x.element_size() == 2 else torch.int32)
        total, step = 0, 1 << 26
        for lo in range(0, bits.numel(), step):
            chunk = bits[lo:lo + step].to(torch.int64)
            w = torch.arange(lo, lo + chunk.numel(), device=x.device,
                             dtype=torch.int64) % 65521 + 1
            total += int((chunk * w).sum())
        out.append(total)
    return out


CONVEX_COLUMNS = ("step", "stage", "window", "time", "accesses",
                  "f_window", "f_full")


def plane_meter_checks(name: str, sess, tr) -> dict:
    """The plane's meter after a run: every example loaded and uploaded
    exactly once (no re-upload: the bytes uploaded are the corpus's),
    and the accesses the clock's.  Returns the integer counters."""
    m = tr.meta["data_plane"]
    ds = sess.dataset
    row_bytes = sum(st.example_nbytes for st in ds.stores)
    ints = {k: v for k, v in m.items() if isinstance(v, int)}
    bad = []
    if not m["examples_loaded"] == m["examples_uploaded"] == ds.n:
        bad.append(f"loaded {m['examples_loaded']}, uploaded "
                   f"{m['examples_uploaded']} of {ds.n} examples")
    if not m["bytes_uploaded"] == m["bytes_loaded"] == ds.n * row_bytes:
        bad.append(f"{m['bytes_uploaded']} bytes uploaded, "
                   f"{m['bytes_loaded']} loaded, the corpus is "
                   f"{ds.n * row_bytes}")
    if m["examples_accessed"] != sess.clock.data_accesses:
        bad.append(f"{m['examples_accessed']} accesses metered, the clock "
                   f"charged {sess.clock.data_accesses}")
    for b in bad:
        fail_later(f"{name}: {b}")
    return ints


RUN_COUNTERS = ("host_transfers", "race_overshoot", "stages")


def run_record(tr, cols=CONVEX_COLUMNS, before=()) -> dict:
    """A trace's columns, extras and run counters as plain lists and
    values; ``before`` (a restored run's saved point dicts) goes ahead of
    the trace's own points, so a resumed run reads as one whole run."""
    return {"columns": {c: [q[c] for q in before] + tr.column(c)
                        for c in cols},
            "extra": [q["extra"] for q in before]
            + [q.extra for q in tr.points],
            **{k: tr.meta.get(k) for k in RUN_COUNTERS}}


def bitwise_diff(a: dict, b: dict) -> list:
    """What differs between two ``run_record``s: the columns by name, then
    ``extra`` and the run counters (empty: nothing)."""
    return [c for c in a["columns"] if a["columns"][c] != b["columns"][c]] \
        + [k for k in ("extra",) + RUN_COUNTERS if a[k] != b[k]]


def convex_plane_phase(torch, rt, scale: float = 6.0) -> int:
    """quickstart@6 through the streaming plane (768 shards of 64 rows;
    ``scale`` sets another size), two-track then batch, each against the
    same spec on the host path bit for bit (every column, the final w,
    transfers and B1 launches); each run's launches counted from 0.  Then
    BENCH_data.json's setting: a throttled memmap store in a temporary
    directory.  Returns the plane runs' B1 launches."""
    api, ops, methods = rt["api"], rt["ops"], rt["methods"]
    data, base = quickstart_specs(api, scale)
    runs = {
        "two_track": api.RunSpec(policy=api.PolicySpec(
            "two_track", {"final_steps": 20}), **base),
        "batch": api.RunSpec(policy=api.PolicySpec("batch", {"steps": 25}),
                             **base),
    }
    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as workdir:
        mm = api.DataSpec(lam=1e-3, store="memmap", workdir=workdir,
                          **MEMMAP_DATA)
        inner, final = MEMMAP_STEPS
        runs["memmap_fig3"] = api.RunSpec(
            data=mm, policy=api.PolicySpec(
                "fixed_steps", {"inner_steps": inner, "final_steps": final}),
            optimizer=api.OptimizerSpec(
                "newton_cg", {"hessian_fraction": MEMMAP_HESSIAN}),
            schedule=api.ScheduleSpec(n0=MEMMAP_N0))
        total = 0
        for name, spec in runs.items():
            out = {}
            for plane in ("host", "plane"):
                sess = api.build(spec.replace(
                    data=spec.data.replace(plane=plane)), device="cuda")
                torch.cuda.synchronize()
                ops.reset_calls()
                tr, stamps, t0, wall = timed_run(torch, sess)
                walls = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
                out[plane] = (sess, tr, ops.CALLS["linear_value_grad"],
                              walls, wall)
            (hs, htr, hl, _, hwall), (ps, ptr, pl, walls, pwall) = \
                out["host"], out["plane"]
            differ = bitwise_diff(run_record(ptr), run_record(htr))
            if not torch.equal(ptr.params, htr.params):
                differ.append("params")
            if pl != hl:
                differ.append("launches")
            ints = plane_meter_checks(f"convex plane {name}", ps, ptr)
            m = ptr.meta["data_plane"]
            st = ps.dataset.stores[0]
            emit({"path": "convex_plane", "run": name,
                  "n": ps.dataset.n, "d": ps.dataset.d,
                  "shard_size": st.shard_size, "shards": st.num_shards,
                  "store": spec.data.store, "delay_ms": spec.data.delay_ms,
                  "steps": len(ptr.points), "stages": ptr.meta["stages"],
                  "host_transfers": ptr.meta["host_transfers"],
                  "linear_value_grad_launches": pl, "host_path_launches": hl,
                  "implied_launches": methods.kernel_calls(ptr),
                  "meter": ints, "overlap_fraction": m["overlap_fraction"],
                  "reuse_ratio": m["reuse_ratio"],
                  "load_time_s": m["load_time_s"],
                  "blocked_time_s": m["blocked_time_s"],
                  "stage_wall_s": walls, "wall_s": pwall,
                  "host_path_wall_s": hwall,
                  "f_full": ptr.final().f_full,
                  "differs_from_host_path": differ})
            if differ:
                fail_later(f"convex plane {name}: differs from the host "
                           f"path in {differ}")
            if pl != methods.kernel_calls(ptr):
                fail_later(f"convex plane {name}: {pl} launches, the trace "
                           f"implies {methods.kernel_calls(ptr)}")
            total += pl
            del out, hs, ps
    return total


def lm_plane_vs_host_phase(torch, rt, arch: str) -> dict:
    """A short full-width run of an LM main path (its width and depth,
    fixed_steps over two stages of two steps) on the host path and on the
    plane: the loss per stage, f̂, every trace column and the parameters'
    checksum held bitwise, the kernels' launches equal.  One session at a
    time: the hybrid holds most of the card."""
    api, ops = rt["api"], rt["ops"]
    if arch == "falcon-mamba-7b":
        kw = dict(corpus=LM_CORPUS, seq_len=LM_SEQ, layers=LM_LAYERS,
                  batch=LM_BATCH)
    else:
        kw = dict(corpus=HY_CORPUS, seq_len=HY_SEQ, layers=HY_LAYERS,
                  batch=HY_BATCH, eval_rows=HY_EVAL_ROWS)
    out = {}
    for plane in ("host", "plane"):
        spec = lm_spec(api, arch=arch, reduced=False, policy="fixed_steps",
                       n0=kw["corpus"] // 2, fixed=SHORT_STEPS, plane=plane,
                       **kw)
        sess = api.build(spec, device="cuda")
        torch.cuda.synchronize()
        ops.reset_calls()
        t0 = time.perf_counter()
        tr = sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[plane] = {"trace": tr, "launches": dict(ops.CALLS), "wall": wall,
                      "checksum": checksum(torch, rt, tr.params),
                      "meter": tr.meta.get("data_plane")}
        if plane == "plane":
            plane_meter_checks(f"{arch} plane", sess, tr)
        tr.params = None
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    h, p = out["host"], out["plane"]
    differ = bitwise_diff(run_record(p["trace"]), run_record(h["trace"]))
    if p["checksum"] != h["checksum"]:
        differ.append("params")
    if p["launches"] != h["launches"]:
        differ.append("launches")
    ptr = p["trace"]
    row = {"path": "lm_plane_vs_host", "arch": arch,
           "steps": len(ptr.points), "stages": ptr.meta["stages"],
           "loss_per_stage": [[q.f_window for q in ptr.points
                               if q.stage == st]
                              for st in sorted(set(ptr.column("stage")))],
           "f_full": ptr.column("f_full"), "launches": p["launches"],
           "host_path_launches": h["launches"],
           "meter": {k: v for k, v in p["meter"].items()
                     if isinstance(v, int)},
           "wall_s": p["wall"], "host_path_wall_s": h["wall"],
           "param_leaves": len(p["checksum"]),
           "differs_from_host_path": differ}
    emit(row)
    if differ:
        fail_later(f"{arch}: the plane differs from the host path in "
                   f"{differ}")
    return row


class Killed(Exception):
    """Ends a run at a stage boundary, after its checkpoint is written."""


def timed_checkpoints(torch, sess, rec: dict) -> None:
    """Time each checkpoint the session writes and reads (host clock,
    ended by the file write or by the tensors' landing on the card)."""
    ck = sess.checkpointer
    save, restore = ck.save, ck.restore

    def timed_save(end):
        t0 = time.perf_counter()
        path = save(end)
        rec.setdefault("write_s", []).append(time.perf_counter() - t0)
        rec["bytes"] = sum(os.path.getsize(path.with_suffix(x))
                           for x in (".npz", ".json"))
        return path

    def timed_restore(*a):
        t0 = time.perf_counter()
        out = restore(*a)
        torch.cuda.synchronize()
        rec.setdefault("read_s", []).append(time.perf_counter() - t0)
        return out

    ck.save, ck.restore = timed_save, timed_restore


def kill_and_resume(torch, rt, spec, kill_stage: int, cols,
                    tiered: bool = False) -> dict:
    """``spec`` run whole, then run with stage checkpoints in a temporary
    directory and killed after ``kill_stage``, then resumed from disk in a
    fresh session (``resume_session``): the stitched run held bitwise
    against the whole one (the columns, extras, transfers, overshoot and
    the final parameters' checksum), the rewarm record the stage's
    window, the kernels' launches of the two pieces summing to the whole
    run's.  A ``tiered`` run's rewarm is its checkpointed hot window, at
    most ``hot_cap`` rows, and its resumed sweep re-reads what the lost
    host ring held, so of the meters only the accesses must equal the
    whole run's.  The directory is deleted at the end."""
    api, ops = rt["api"], rt["ops"]
    sess = api.build(spec, device="cuda")
    torch.cuda.synchronize()
    ops.reset_calls()
    whole = sess.run()
    torch.cuda.synchronize()
    launches = {"whole": dict(ops.CALLS)}
    whole_sum = checksum(torch, rt, whole.params)
    whole.params = None
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    rec = {}
    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as d:
        sess = api.build(spec.replace(checkpoint=spec.checkpoint.replace(
            directory=d)), device="cuda")
        timed_checkpoints(torch, sess, rec)

        def die(end):
            if end.info.stage == kill_stage:
                raise Killed

        sess.on_stage(die)
        ops.reset_calls()
        try:
            sess.run()
        except Killed:
            pass
        else:
            raise SystemExit("the killed run ran to its end")
        torch.cuda.synchronize()
        launches["killed"] = dict(ops.CALLS)
        del sess
        gc.collect()
        torch.cuda.empty_cache()
        resumed = api.resume_session(d, device="cuda")
        timed_checkpoints(torch, resumed, rec)
        ops.reset_calls()
        t0 = time.perf_counter()
        tr = resumed.run()
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        launches["resumed"] = dict(ops.CALLS)
        points = resumed.restored.trace_points()
        n_t = resumed.restored.n_t
        hot_cap = getattr(resumed.dataset, "hot_cap", None)
        left = sorted(os.listdir(d))
    differ = bitwise_diff(run_record(tr, cols, before=points),
                          run_record(whole, cols))
    resumed_sum = checksum(torch, rt, tr.params)
    if resumed_sum != whole_sum:
        differ.append("params")
    pieces = {k: launches["killed"].get(k, 0) + launches["resumed"].get(k, 0)
              for k in launches["whole"]}
    rewarm = tr.meta["resume_rewarm"]
    row = {"resumed_from_stage": tr.meta["resumed_from_stage"],
           "steps_before": len(points), "steps_after": len(tr.points),
           "n_t": n_t, "rewarm": rewarm,
           "data_plane": {k: v for k, v in tr.meta["data_plane"].items()
                          if isinstance(v, int)},
           "launches": launches, "checkpoint_bytes": rec.get("bytes"),
           "checkpoint_write_s": rec.get("write_s"),
           "checkpoint_read_s": rec.get("read_s"),
           "checkpoints_left_on_disk": left,
           "resumed_wall_s": resume_wall,
           "f_full_final": tr.final().f_full,
           "differs_from_whole_run": differ}
    if differ:
        fail_later(f"resume of {spec.name}: differs from the whole run in "
                   f"{differ}")
    if tiered:
        row["hot_cap"] = hot_cap
        if not rewarm.get("examples_loaded") == \
                rewarm.get("rewarm_examples") <= hot_cap:
            fail_later(f"resume of {spec.name}: rewarm {rewarm}, the hot "
                       f"window holds {hot_cap} rows")
    elif rewarm.get("examples_loaded") != n_t:
        fail_later(f"resume of {spec.name}: rewarm loaded "
                   f"{rewarm.get('examples_loaded')} examples, the stage's "
                   f"window is {n_t}")
    if pieces != launches["whole"]:
        fail_later(f"resume of {spec.name}: launches {pieces} in two "
                   f"pieces, {launches['whole']} whole")
    for k in ("examples_accessed",) if tiered else (
            "examples_loaded", "examples_uploaded", "examples_accessed"):
        if tr.meta["data_plane"][k] != whole.meta["data_plane"][k]:
            fail_later(f"resume of {spec.name}: {k} "
                       f"{tr.meta['data_plane'][k]} against the whole run's "
                       f"{whole.meta['data_plane'][k]}")
    return row


def resume_phase(torch, rt) -> dict:
    """Kill-and-resume on the plane: quickstart@6 two-track killed after
    stage 1; falcon-mamba-7b two-track at full width, one layer, killed
    after stage 1 with one checkpoint kept."""
    api = rt["api"]
    data, base = quickstart_specs(api)
    convex = api.RunSpec(
        name="convex_two_track", policy=api.PolicySpec(
            "two_track", {"final_steps": 20}),
        **dict(base, data=data.replace(plane="plane")))
    row = kill_and_resume(torch, rt, convex, 1, CONVEX_COLUMNS)
    emit({"path": "resume", "run": "convex", **row})
    lm = lm_spec(api, reduced=False, policy="two_track",
                 corpus=RESUME_CORPUS, seq_len=LM_SEQ, n0=RESUME_N0,
                 max_stage_iters=RESUME_ITERS, layers=RESUME_LAYERS)
    lm = lm.replace(checkpoint=api.CheckpointSpec(keep=1))
    lm_row = kill_and_resume(torch, rt, lm, 1, CONVEX_COLUMNS)
    emit({"path": "resume", "run": "falcon-mamba-7b", "layers": RESUME_LAYERS,
          **lm_row})
    return {"convex": row, "lm": lm_row}


# the multi-host runtime (dist/) and elastic recovery (elastic/): 4
# simulated hosts, all lanes on the one card
HOSTS = 4
# BENCH_dist.json's setting (the reference's bench_dist.py): webspam_like at
# scale 0.125 (2,048 x 1,024), memmap shards of 128 rows read with a 1 ms
# delay, fixed_steps (5, 25), n0 256, Newton-CG on the whole window
DIST_DATA = dict(dataset="webspam_like", scale=0.125, shard_size=128,
                 delay_ms=1.0)
DIST_N0, DIST_STEPS = 256, (5, 25)
# the trajectory bound against one host: the lanes' partial sums
# re-associate the float32 reduction (the reference's bench_dist.py)
DIST_RTOL = 1e-3
# the straggler: a read of its shards takes SLOW_S, ten times the deadline
# of the stage flush, so its backlog outlasts the deadline on any host
SLOW_S, DEADLINE_S = 0.2, 0.02
# the LMs over 4 hosts: two stages of two steps at the main paths' widths;
# falcon-mamba-7b at one layer (2 rows a lane a step), recurrentgemma-9b at
# one super-block with one row a lane (a batch of 2 does not split over 4)
DIST_LM_LAYERS, DIST_HY_BATCH = 1, 4
PEAK_SLACK_BYTES = 100 * 2**20


def lanes_at(sess, n: int) -> int:
    """How many lanes of a distributed session's window of ``n`` hold
    rows — B1's launches for one ``value_and_grad`` there."""
    own = sess.dataset.ownership
    return sum(own.examples_in_prefix(h, n) > 0
               for h in range(own.num_hosts))


def dist_kernel_calls(sess, tr) -> int:
    """The B1 launches a distributed convex run's trace implies: per step,
    one per non-empty lane of its window, and a race step's fast track one
    per non-empty lane of the previous window (the race stops at its
    trigger; the WHILE graph's replays are counted)."""
    plan = {i.stage: i for i in sess.stage_plan()}
    total = 0
    for end in sess.stage_ends:
        info = plan[end["stage"]]
        pts = [p for p in tr.points if p.stage == info.stage]
        race = sum("f_fast_on_t" in p.extra for p in pts)
        total += len(pts) * lanes_at(sess, info.n_t) \
            + race * lanes_at(sess, info.n_prev)
    return total


def stage_deltas(tr, row_bytes: int) -> list:
    """The collective stage records, cumulative per host, differenced into
    each stage's new examples, loads and uploads, and the bytes uploaded
    beyond the new examples' (re-upload; the reference's bench_dist.py)."""
    out, prev = [], {}
    for rec in tr.meta["host_stage_records"]:
        hosts = []
        for r in rec["hosts"]:
            base = prev.get(r["host"], {"resident": 0, "bytes_uploaded": 0,
                                        "examples_loaded": 0})
            new = r["resident"] - base["resident"]
            up = r["bytes_uploaded"] - base["bytes_uploaded"]
            hosts.append({"host": r["host"], "window": r["window"],
                          "new_examples": new,
                          "examples_loaded": r["examples_loaded"]
                          - base["examples_loaded"],
                          "uploaded_bytes": up,
                          "reupload_bytes": up - new * row_bytes})
            prev[r["host"]] = r
        out.append({"stage": rec["stage"], "n_t": rec["n_t"], "hosts": hosts})
    return out


def rel_dev(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def traj_dev(tr, ref) -> float:
    return max(rel_dev(tr.column(c), ref.column(c))
               for c in ("f_window", "f_full"))


def dist_claims(name: str, sess, tr, single=None) -> dict:
    """BENCH_dist.json's claims for a distributed run (against ``single``,
    the same spec on one host, when given); each failure fails the run at
    its end.  Returns the line's numbers."""
    ds = sess.dataset
    row_bytes = sum(st.example_nbytes for st in ds.stores)
    loaded = [m.examples_loaded for m in ds.host_meters]
    owned = [ds.ownership.num_owned_examples(h) for h in range(len(loaded))]
    meter = tr.meta["dist"]["meter"]
    stages = stage_deltas(tr, row_bytes)
    reupload = sum(abs(h["reupload_bytes"]) for s in stages
                   for h in s["hosts"])
    claims = {
        "per_host_loads_are_owned_slice_only": loaded == owned,
        "per_host_share_within_one_shard_of_global_over_n": all(
            abs(k - ds.n / len(loaded)) <= ds.ownership.shard_size
            for k in loaded),
        "each_example_loaded_once_globally": meter["examples_loaded"] == ds.n,
        "zero_resident_reupload_per_stage_per_host": reupload == 0,
        "one_collective_flush_per_stage": all(
            len(r["hosts"]) == len(loaded)
            for r in tr.meta["host_stage_records"]) and
        len(tr.meta["host_stage_records"]) == tr.meta["stages"],
        "accesses_are_the_clocks":
            meter["examples_accessed"] == sess.clock.data_accesses,
    }
    row = {"per_host_examples_loaded": loaded,
           "per_host_owned_examples": owned, "global_meter": {
               k: v for k, v in meter.items() if isinstance(v, int)},
           "reupload_bytes": reupload,
           "host_transfers": tr.meta["host_transfers"],
           "stages": tr.meta["stages"]}
    if single is not None:
        row["single_host_transfers"] = single.meta["host_transfers"]
        row["trajectory_max_rel_dev"] = traj_dev(tr, single)
        claims["host_transfers_equal_single_host"] = \
            tr.meta["host_transfers"] == single.meta["host_transfers"]
        claims["trajectory_matches_single_host_within_fp_tolerance"] = \
            all(tr.column(c) == single.column(c)
                for c in ("step", "stage", "window", "time", "accesses")) \
            and row["trajectory_max_rel_dev"] <= DIST_RTOL
    for k, ok in claims.items():
        if not ok:
            fail_later(f"{name}: claim {k} does not hold ({row})")
    return dict(row, claims=claims)


def timed_build_run(torch, rt, spec):
    """Build and run ``spec`` on the card, with the B1 launches of the run
    counted from 0; returns (session, trace, launches, wall seconds)."""
    sess = rt["api"].build(spec, device="cuda")
    torch.cuda.synchronize()
    rt["ops"].reset_calls()
    t0 = time.perf_counter()
    tr = sess.run()
    torch.cuda.synchronize()
    return sess, tr, rt["ops"].CALLS["linear_value_grad"], \
        time.perf_counter() - t0


def lane_times(torch, rt, sess, data) -> dict:
    """The card's time of one ``value_and_grad`` over the 4 lanes of the
    whole window (B1 once a lane, the partials summed) against one over
    the same rows as one window, and of B1 alone on one lane and on the
    whole window: the cost of launching per lane (CUDA events, after
    warm-up)."""
    api, ops = rt["api"], rt["ops"]
    ds, objective, _ = api.convex_problem(data, device=sess.device)
    hw = sess.dataset.window(sess.dataset.n)
    X, y = hw.fields
    m = hw.host_counts[0]
    w = 0.01 * torch.ones(ds.d, device=sess.device)
    spin = spin_cycles_per_s(torch)
    fns = {
        "value_and_grad_lanes": lambda: sess.objective.value_and_grad(w, hw),
        "value_and_grad_window": lambda: objective.value_and_grad(
            w, (ds.X, ds.y)),
        "b1_one_lane": lambda: ops.linear_value_grad(X[0, :m], y[0, :m], w),
        "b1_window": lambda: ops.linear_value_grad(ds.X, ds.y, w)}
    row = {"path": "dist_lane_times", "lanes": hw.num_hosts,
           "rows_per_lane": m, "n": ds.n, "d": ds.d}
    for name, fn in fns.items():
        t = time_ms(torch, fn, spin)
        row[f"{name}_ms"], row[f"{name}_call_ms"] = t["ms"], t["call_ms"]
    emit(row)
    return row


def dist_convex_phase(torch, rt, scale: float = 6.0) -> int:
    """quickstart@6 over 4 simulated hosts on the plane (64-row shards):
    two-track as quickstart gives it, its B1 launches against the count
    its trace and lane counts imply, BENCH_dist.json's claims and the CPU
    run; then at hessian_fraction 1 (the subsample is the identity on
    both layouts, so the lanes' re-associated sums are the only
    difference, as in the reference's benchmark) against one host within
    rel 1e-3; then BENCH_dist.json's own setting.  ``scale`` sets another
    size of quickstart.  Returns the first run's launches."""
    api = rt["api"]
    data, base = quickstart_specs(api, scale)
    topo = api.TopologySpec(hosts=HOSTS)
    spec = api.RunSpec(name="dist_quickstart", policy=api.PolicySpec(
        "two_track", {"final_steps": 20}), topology=topo,
        **dict(base, data=data.replace(plane="plane")))
    sess, tr, launches, wall = timed_build_run(torch, rt, spec)
    rt["dist_while"] = rt["ops"].CALLS.get("device_while", 0)
    implied = dist_kernel_calls(sess, tr)
    row = dist_claims("dist quickstart@6", sess, tr)
    cpu = api.build(spec, device="cpu").run()
    differ = [c for c in ("step", "stage", "window", "time", "accesses")
              if cpu.column(c) != tr.column(c)]
    card_vs_cpu = traj_dev(tr, cpu)
    emit({"path": "dist_convex", "run": "quickstart@6", "hosts": HOSTS,
          "n": sess.dataset.n, "shard_size": sess.dataset.ownership.shard_size,
          "steps": len(tr.points), "wall_s": wall,
          "linear_value_grad_launches": launches, "implied_launches": implied,
          "lanes_per_stage": [lanes_at(sess, e["n_t"])
                              for e in sess.stage_ends],
          "f_full": tr.final().f_full, "cpu_columns_differ": differ,
          "card_vs_cpu_max_rel": card_vs_cpu, **row})
    if launches != implied:
        fail_later(f"dist quickstart@6: B1 launched {launches} times, the "
                   f"trace and lane counts imply {implied}")
    pulls = [b["transfers"] - a["transfers"] for a, b in
             zip([{"transfers": 0}] + sess.stage_ends, sess.stage_ends)]
    emit({"path": "dist_convex", "run": "quickstart@6",
          "transfers_per_stage": pulls,
          "capture_s": list(sess.engine.race_capture_s)})
    if set(pulls) != {1}:
        fail_later(f"dist quickstart@6: pulls per stage {pulls}, not one "
                   f"a racing stage")
    lane_times(torch, rt, sess, data)
    if differ or not card_vs_cpu <= RTOL_F:
        fail_later(f"dist quickstart@6: card and CPU differ (columns "
                   f"{differ}, f rel {card_vs_cpu} against {RTOL_F})")
    parity = spec.replace(name="dist_parity", optimizer=api.OptimizerSpec(
        "newton_cg", {"hessian_fraction": 1.0}))
    one = api.build(parity.replace(topology=api.TopologySpec()),
                    device="cuda").run()
    psess, ptr, plaunch, pwall = timed_build_run(torch, rt, parity)
    emit({"path": "dist_convex", "run": "quickstart@6_parity",
          "hessian_fraction": 1.0, "steps": len(ptr.points), "wall_s": pwall,
          "linear_value_grad_launches": plaunch,
          "implied_launches": dist_kernel_calls(psess, ptr),
          **dist_claims("dist quickstart@6 parity", psess, ptr, one)})
    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as workdir:
        inner, final = DIST_STEPS
        bench = api.RunSpec(
            name="bench_dist", data=api.DataSpec(
                lam=1e-3, plane="plane", store="memmap", workdir=workdir,
                **DIST_DATA),
            policy=api.PolicySpec("fixed_steps", {"inner_steps": inner,
                                                  "final_steps": final}),
            optimizer=api.OptimizerSpec("newton_cg",
                                        {"hessian_fraction": 1.0}),
            schedule=api.ScheduleSpec(n0=DIST_N0), topology=topo)
        one = api.build(bench.replace(
            topology=api.TopologySpec(),
            data=bench.data.replace(plane="host")), device="cuda").run()
        bsess, btr, blaunch, bwall = timed_build_run(torch, rt, bench)
        m = btr.meta["dist"]["meter"]
        emit({"path": "dist_convex", "run": "bench_dist", "hosts": HOSTS,
              "n": bsess.dataset.n, "d": bsess.dataset.d,
              "steps": len(btr.points), "wall_s": bwall,
              "overlap_fraction": m["overlap_fraction"],
              "blocked_time_s": m["blocked_time_s"],
              "linear_value_grad_launches": blaunch,
              "implied_launches": dist_kernel_calls(bsess, btr),
              **dist_claims("bench_dist", bsess, btr, one)})
    return launches


def elastic_convex_phase(torch, rt, scale: float = 6.0) -> dict:
    """BENCH_elastic.json's claims on the 4-host quickstart@6 run: a host
    killed after stage 1 (the trajectory bit for bit the unfaulted run's,
    the re-read the lost lane's owned slice of the window, no survivor
    re-uploading a byte); a straggler (its reads SLOW_S each from stage 1
    on, a DEADLINE_S flush; at hessian_fraction 1, against the unfaulted
    run within rel 1e-3: shards migrated, each example loaded once, the
    windows a partition at every stage); a kill-and-resume from a
    "distributed" stage checkpoint, bit for bit.  ``scale`` sets another
    size of quickstart."""
    api = rt["api"]
    data, base = quickstart_specs(api, scale)
    spec = api.RunSpec(
        name="elastic_quickstart", policy=api.PolicySpec(
            "two_track", {"final_steps": 20}),
        topology=api.TopologySpec(hosts=HOSTS),
        elastic=api.ElasticSpec(enabled=True),
        **dict(base, data=data.replace(plane="plane")))
    _, whole, wl, wwall = timed_build_run(torch, rt, spec)
    ksess, killed, kl, kwall = timed_build_run(
        torch, rt, spec.replace(elastic=api.ElasticSpec(
            faults=("kill@1:2",))))
    differ = bitwise_diff(run_record(killed), run_record(whole))
    if not torch.equal(killed.params, whole.params):
        differ.append("params")
    if kl != wl:
        differ.append("launches")
    (kill,) = [e for g in killed.meta["elastic_events"] for e in g["events"]]
    lane = kill["lanes"][0]
    row_bytes = sum(st.example_nbytes for st in ksess.dataset.stores)
    survivors = sum(h["reupload_bytes"]
                    for s in stage_deltas(killed, row_bytes)
                    for h in s["hosts"] if h["host"] != lane["lane"])
    host_loss = {"lane": lane["lane"], "adopted_by": lane["adopted_by"],
                 "window_at_loss": lane["window"],
                 "reread_examples": lane["reread_examples"],
                 "reread_bytes": lane["reread_bytes"],
                 "owned_examples": lane["owned_examples"],
                 "survivor_reupload_bytes": survivors,
                 "differs_from_unfaulted": differ, "wall_s": kwall,
                 "unfaulted_wall_s": wwall}
    emit({"path": "elastic_convex", "run": "host_loss", **host_loss})
    if differ:
        fail_later(f"elastic host loss: differs from the unfaulted run in "
                   f"{differ}")
    if lane["reread_examples"] != lane["window"] or \
            lane["reread_bytes"] != lane["window"] * row_bytes or survivors:
        fail_later(f"elastic host loss: re-read {lane['reread_examples']} "
                   f"examples for a lane window of {lane['window']}, "
                   f"survivors re-uploaded {survivors} bytes")
    slow = spec.replace(optimizer=api.OptimizerSpec(
        "newton_cg", {"hessian_fraction": 1.0}))
    calm = api.build(slow.replace(elastic=api.ElasticSpec(
        enabled=True, capacity_slack=2.0)), device="cuda").run()
    ssess, strag, _, swall = timed_build_run(
        torch, rt, slow.replace(elastic=api.ElasticSpec(
            faults=(f"slow@1:1={SLOW_S}",), straggler_deadline_s=DEADLINE_S,
            capacity_slack=2.0)))
    moves = [e for g in strag.meta.get("elastic_events", [])
             for e in g["events"] if e["kind"] == "rebalance"]
    loaded = [m.examples_loaded for m in ssess.dataset.host_meters]
    straggler = {
        "slow_s": SLOW_S, "deadline_s": DEADLINE_S,
        "rebalances": len(moves),
        "shards_migrated": sum(len(m["shards"]) for m in moves),
        "per_lane_examples_loaded": loaded,
        "windows_partition_every_stage": all(
            sum(r["window"] for r in rec["hosts"]) == rec["n_t"]
            for rec in strag.meta["host_stage_records"]),
        "trajectory_max_rel_dev": traj_dev(strag, calm), "wall_s": swall}
    emit({"path": "elastic_convex", "run": "straggler", **straggler})
    if not (straggler["shards_migrated"] > 0
            and sum(loaded) == ssess.dataset.n
            and straggler["windows_partition_every_stage"]
            and straggler["trajectory_max_rel_dev"] <= DIST_RTOL):
        fail_later(f"elastic straggler: a claim does not hold ({straggler})")
    resume = kill_and_resume(torch, rt, spec, 1, CONVEX_COLUMNS)
    emit({"path": "resume", "run": "convex_4_hosts", **resume})
    return {"host_loss": host_loss, "straggler": straggler}


def dist_lm_phase(torch, rt, arch: str) -> dict:
    """An LM main path's width over 4 simulated hosts for two stages of two
    steps (falcon-mamba-7b at one layer, 8 x 256; recurrentgemma-9b at one
    super-block, 4 x 4096): the kernels' launches against the trace's
    count, the peak memory against the same run on one host (within
    PEAK_SLACK_BYTES); for falcon-mamba-7b also a run with host 1 killed
    after stage 0, bit for bit the unfaulted run."""
    api, ops = rt["api"], rt["ops"]
    if arch == "falcon-mamba-7b":
        kw = dict(corpus=LM_CORPUS, seq_len=LM_SEQ, layers=DIST_LM_LAYERS,
                  batch=LM_BATCH)
    else:
        kw = dict(corpus=HY_CORPUS, seq_len=HY_SEQ, layers=HY_LAYERS,
                  batch=DIST_HY_BATCH, eval_rows=HY_EVAL_ROWS)
    spec = lm_spec(api, arch=arch, reduced=False, policy="fixed_steps",
                   n0=kw["corpus"] // 2, fixed=SHORT_STEPS, **kw)
    runs = {"one_host": spec,
            "hosts": spec.replace(topology=api.TopologySpec(hosts=HOSTS))}
    if arch == "falcon-mamba-7b":
        runs["killed"] = runs["hosts"].replace(
            elastic=api.ElasticSpec(faults=("kill@0:1",)))
    out = {}
    for name, s in runs.items():
        # the earlier phases' garbage freed first: each run's peak is its
        # own above the same base
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        sess = api.build(s, device="cuda")
        cfg = sess.model_config
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_calls()
        t0 = time.perf_counter()
        tr = sess.run()
        torch.cuda.synchronize()
        out[name] = {"trace": tr, "launches": dict(ops.CALLS),
                     "wall_s": time.perf_counter() - t0,
                     "peak": torch.cuda.max_memory_allocated() - base,
                     "base": base,
                     "checksum": checksum(torch, rt, tr.params),
                     "events": tr.meta.get("elastic_events")}
        tr.params = None
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    types = cfg.layer_types()
    passes = 3 * len(out["hosts"]["trace"].points)
    implied = {"ssm_scan": types.count("ssm") * passes} \
        if arch == "falcon-mamba-7b" else \
        {"rglru_scan": types.count("rec") * passes,
         "flash_attention": types.count("attn") * passes}
    h = out["hosts"]
    row = {"path": "dist_lm", "arch": arch, "hosts": HOSTS,
           "layers": cfg.num_layers, "batch": kw["batch"],
           "seq_len": kw["seq_len"], "steps": len(h["trace"].points),
           "launches": h["launches"], "implied": implied,
           "f_window": h["trace"].column("f_window"),
           "f_full": h["trace"].column("f_full"),
           "one_host_f_full": out["one_host"]["trace"].column("f_full"),
           "wall_s": {k: v["wall_s"] for k, v in out.items()},
           "peak_memory_bytes": {k: v["peak"] for k, v in out.items()},
           "base_memory_bytes": {k: v["base"] for k, v in out.items()},
           "data_plane_hosts": {
               k: v["examples_loaded"] for k, v in
               h["trace"].meta["data_plane_hosts"].items()}}
    if "killed" in out:
        k = out["killed"]
        differ = bitwise_diff(run_record(k["trace"]), run_record(h["trace"]))
        if k["checksum"] != h["checksum"]:
            differ.append("params")
        if k["launches"] != h["launches"]:
            differ.append("launches")
        row["kill"] = {"events": k["events"],
                       "differs_from_unfaulted": differ}
        if differ:
            fail_later(f"{arch} over {HOSTS} hosts: the killed run differs "
                       f"from the unfaulted one in {differ}")
    emit(row)
    vals = h["trace"].column("f_window") + h["trace"].column("f_full")
    if not all(math.isfinite(v) for v in vals):
        fail_later(f"{arch} over {HOSTS} hosts: non-finite values")
    for name, n in implied.items():
        if h["launches"].get(name, 0) != n:
            fail_later(f"{arch} over {HOSTS} hosts: {name} launched "
                       f"{h['launches'].get(name, 0)} times, the trace "
                       f"implies {n}")
    if abs(h["peak"] - out["one_host"]["peak"]) > PEAK_SLACK_BYTES:
        fail_later(f"{arch} over {HOSTS} hosts: peak {h['peak']} bytes "
                   f"against {out['one_host']['peak']} on one host")
    return row


def process_phase(torch, rt, device: str = "cuda") -> dict:
    """A one-process ProcessTopology: NCCL at world size 1 on this card
    (tcp://localhost; gloo when ``device`` is the CPU), the all-reduce and
    the record all-gather, and a DistributedDataset under it giving the
    simulated 1-host views and objective bit for bit."""
    import socket
    import torch.distributed as dist
    from repro_torch import dist as tdist
    from repro_torch.data.shards import InMemoryShardStore
    api = rt["api"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        # on the card: cuda:{local rank}, the topology's own choice
        topo = tdist.ProcessTopology(
            device=None if device == "cuda" else device)
        comm = tdist.ProcessCollectives()
        x = torch.arange(4, dtype=torch.float32, device=device)
        summed = comm.psum([x, x], 1)
        gathered = comm.all_gather_records([{"host": 0}])
        data, _ = quickstart_specs(api, 1.0)
        ds, _, _ = api.convex_problem(data, device="cpu")
        X, y = ds.X.numpy(), ds.y.numpy()
        views_equal, n_ts = [], (128, 1000, ds.n)
        with tdist.DistributedDataset(
                [InMemoryShardStore(X, 64), InMemoryShardStore(y, 64)],
                topology=topo) as pd, tdist.DistributedDataset(
                [InMemoryShardStore(X, 64), InMemoryShardStore(y, 64)],
                topology=tdist.SimulatedTopology(1, devices=(device,))) \
                as sd:
            for n_t in n_ts:
                a, b = pd.window(n_t), sd.window(n_t)
                views_equal.append(a.host_counts == b.host_counts and all(
                    torch.equal(fa, fb) for fa, fb in zip(a.fields,
                                                          b.fields)))
            w = torch.full((ds.d,), 0.01, device=device)
            fa, ga = tdist.DistributedObjective(lam=1e-3, comm=comm) \
                .value_and_grad(w, pd.window(ds.n))
            fb, gb = tdist.DistributedObjective(lam=1e-3).value_and_grad(
                w, sd.window(ds.n))
            objective_equal = torch.equal(fa, fb) and torch.equal(ga, gb)
        torch.cuda.synchronize()
        row = {"path": "process_topology", "backend": dist.get_backend(),
               "world_size": dist.get_world_size(),
               "topology": topo.describe(),
               "all_reduce": summed.tolist(), "all_gather": gathered,
               "views_bitwise_simulated": views_equal,
               "objective_bitwise_simulated": objective_equal}
    finally:
        dist.destroy_process_group()
    emit(row)
    if row["all_reduce"] != [0.0, 2.0, 4.0, 6.0] or \
            gathered != [{"host": 0}] or not all(views_equal) or \
            not objective_equal:
        fail_later(f"process topology: {row}")
    return row


# the launch tooling's phase (3q): the dry run's two combinations of
# qwen3-0.6b on the 16×16 fake world, and one train step at 3i's batch on
# a (1, 1) mesh held to the plain step within MESH_TOL relative (where it
# is not bitwise)
MESH_ARCH = "qwen3-0.6b"
MESH_DRY_RUNS = (("train_4k", "fsdp_tp"), ("decode_32k", "tp"))
MESH_POLICY = "fsdp_tp+act"
MESH_TOL = 1e-6


def _rel_err(a, b) -> float:
    d = (a.double() - b.double()).abs().max().item()
    return d / max(b.double().abs().max().item(), 1e-30)


def mesh_dry_run_phase(torch, rt, reduced: bool = False) -> list:
    """3q (a): the dry run's lines, with the train step's top 5 sites.
    ``reduced`` (the CPU test) runs the reduced config on a 2×2 world."""
    dryrun, forensics, mesh = rt["dryrun"], rt["forensics"], rt["mesh"]
    rows = []
    for shape, policy in MESH_DRY_RUNS:
        if reduced:
            cfg = rt["configs"].reduced(rt["configs"].get(MESH_ARCH))
            with mesh.fake_world(4):
                res = dryrun.dry_run(MESH_ARCH, shape, policy=policy,
                                     cfg=cfg,
                                     mesh=mesh.make_host_mesh(model=2))
        else:
            res = dryrun.dry_run(MESH_ARCH, shape, policy=policy)
        row = {"path": "dry_run", "arch": MESH_ARCH, "shape": shape,
               "policy": policy, "torch": res["torch"], "mesh": res["mesh"],
               "chips": res["chips"],
               "flops_per_device": res["flops_per_device"],
               "bytes_per_device": res["bytes_per_device"],
               "wire_bytes_per_device":
                   res["collective_wire_bytes_per_device"],
               "roofline_s": res["roofline"],
               "bottleneck": res["bottleneck"], "trace_s": res["trace_s"],
               "memory": res["memory"],
               "useful_flops_ratio": res["useful_flops_ratio"],
               "collectives": {k: v["count"]
                               for k, v in res["collectives"].items()},
               "replicated": [f"{n['op']} at {n['site']}"
                              for n in res["notes"]],
               "card": rt["smi"]}
        if shape == "train_4k":
            row["top_sites"] = forensics.report(
                forensics.collective_sites(res), 5)[1:]
        emit(row)
        rows.append(row)
        ok = all(math.isfinite(row[k]) and row[k] > 0 for k in
                 ("flops_per_device", "bytes_per_device"))
        if not ok or not res["collectives"]:
            fail_later(f"dry run {shape} {policy}: {row}")
        # the heads' layout is the port's: nothing of attention runs
        # replicated, and the full-width step's count stays near 6·N·D
        attn = [r for r in row["replicated"] if "attention.py" in r]
        if attn:
            fail_later(f"dry run {shape} {policy} ran attention "
                       f"replicated: {attn}")
        if shape == "train_4k" and not reduced and \
                row["flops_per_device"] >= 3 * res["model_flops_per_device"]:
            fail_later(f"dry run {shape} {policy}: "
                       f"{row['flops_per_device']:.3e} FLOPs a device, 3x "
                       f"the model's {res['model_flops_per_device']:.3e}")
    return rows


def mesh_step_phase(torch, rt, device: str = "cuda",
                    reduced: bool = False) -> dict:
    """3q (b): one train step with DTensor parameters on a (1, 1) mesh of
    a one-rank group (NCCL on the card, gloo on the CPU) against the plain
    train step on the same parameters and batch; the dry run's memory for
    the same step beside the allocator's peak."""
    import socket
    import torch.distributed as dist
    configs, T = rt["configs"], rt["transformer"]
    dryrun, mesh, SH = rt["dryrun"], rt["mesh"], rt["shardings"]
    steps, shard_ctx, tree_map = rt["steps"], rt["shard_ctx"], rt["tree_map"]
    cfg = configs.get(MESH_ARCH)
    B, S = TF_BATCH, TF_SEQ
    if reduced:
        cfg = configs.reduced(cfg).with_(dtype=torch.float32)
        B, S = 2, 64
    t0 = time.perf_counter()
    with mesh.fake_world(1):
        pred = dryrun.dry_run(MESH_ARCH, "train_4k", policy=MESH_POLICY,
                              cfg=cfg, mesh=mesh.make_host_mesh(model=1),
                              batch_size=B, seq_len=S)
    predict_s = time.perf_counter() - t0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        m = mesh.make_host_mesh(model=1)
        gen = torch.Generator(device=device).manual_seed(0)
        rows = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                             device=device, dtype=torch.int32)
        batch = {"tokens": rows[:, :-1].contiguous(),
                 "labels": rows[:, 1:].contiguous()}
        params = T.init_params(cfg, 0, device=device)
        base = MESH_POLICY.split("+")[0]
        dparams = SH.distribute_tree(
            params, SH.param_specs_tree(cfg, params, m, base), m)
        dbatch = SH.distribute_tree(
            batch, SH.batch_partition(cfg, batch, m), m)
        dopt = steps.init_opt_state(dparams)
        args_bytes = dryrun._local_bytes((dparams, dopt, dbatch))
        notes: list = []
        step = steps.make_train_step(cfg, notes=notes,
                                     gather_axes=mesh.dp_axes(m))
        plain = steps.make_train_step(cfg)
        shard_ctx.set_sharder(SH.make_activation_sharder(
            m, set(MESH_POLICY.split("+")[1:])))
        try:
            sync(torch, device)
            before = torch.cuda.memory_allocated() if device == "cuda" else 0
            reset_peak(torch, device)
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                new_d, _, md = step(dparams, dopt, dbatch)
                sync(torch, device)
                times.append(time.perf_counter() - t0)
                if not times[1:]:
                    peak = torch.cuda.max_memory_allocated()                         if device == "cuda" else 0
                    first = (tree_map(lambda x: x.to_local(), new_d), md)
                del new_d
        finally:
            shard_ctx.set_sharder(None)
        new_d, md = first
        del dparams, dopt, dbatch
        opt = steps.init_opt_state(params)
        plain_times = []
        for _ in range(2):
            t0 = time.perf_counter()
            new_p, _, mp = plain(params, opt, batch)
            sync(torch, device)
            plain_times.append(time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    leaves = rt["tree_leaves"]
    names = leaf_names(new_p)
    errs, bitwise = {}, True
    for name, a, b in zip(names, leaves(new_d), leaves(new_p)):
        if not torch.equal(a, b):
            bitwise = False
            errs[name] = _rel_err(a, b)
    scalars = {k: (float(md[k]), float(mp[k])) for k in ("loss",
                                                         "grad_norm")}
    for k, (a, b) in scalars.items():
        if a != b:
            bitwise = False
            errs[k] = abs(a - b) / max(abs(b), 1e-30)
    step_bytes = (peak - before + args_bytes) if device == "cuda" else None
    predicted = pred["memory"]["argument_size_in_bytes"] + \
        pred["memory"]["temp_size_in_bytes"]
    row = {"path": "mesh_train_step", "arch": MESH_ARCH,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "batch": [B, S], "policy": MESH_POLICY, "mesh": "1x1",
           "backend": "nccl" if device == "cuda" else "gloo",
           "loss": scalars["loss"], "grad_norm": scalars["grad_norm"],
           "bitwise": bitwise, "max_rel_err": errs,
           "mesh_step_s": times, "plain_step_s": plain_times,
           "torch": torch.__version__,
           "replicated": [f"{n['op']} at {n['site']}" for n in notes],
           "predicted_bytes": predicted,
           "predicted_argument_bytes":
               pred["memory"]["argument_size_in_bytes"],
           "predicted_temp_bytes": pred["memory"]["temp_size_in_bytes"],
           "argument_bytes": args_bytes,
           "max_memory_allocated": peak,
           "memory_before_step": before, "step_bytes": step_bytes,
           "predict_s": predict_s, "card": rt["smi"]}
    emit(row)
    if not bitwise and max(errs.values()) > MESH_TOL:
        fail_later(f"mesh train step against the plain step: {errs}")
    if any("attention.py" in r for r in row["replicated"]):
        fail_later(f"mesh train step ran attention replicated: "
                   f"{row['replicated']}")
    if not all(math.isfinite(v) for pair in scalars.values() for v in pair):
        fail_later(f"mesh train step not finite: {scalars}")
    return row


# the transformer and moe families' main paths (launch/train.py's spec):
# qwen3-0.6b (dense, qk-norm) two-track and granite-moe-1b-a400m (32
# experts, top-8) under fixed_steps, each at its full published width and
# depth; 512 Zipf sequences of 1,025 tokens, batch 8 x 1,024, n0 64, a
# probe of 16 rows, 16 steps a racing stage or 8 a fixed stage, 8 final
TF_RUNS = (("qwen3-0.6b", "two_track"),
           ("granite-moe-1b-a400m", "fixed_steps"))
TF_BATCH, TF_SEQ = 8, 1024
TF_CORPUS, TF_N0, TF_EVAL_ROWS, TF_STAGE_ITERS = 512, 64, 16, 16
TF_FIXED = (8, 8)
# the rest of the zoo at full width and one layer: one forward and
# backward of loss_fn at batch 1 x 512, no optimizer step
ZOO = ("internlm2-1.8b", "yi-9b", "stablelm-12b", "musicgen-medium",
       "llama4-scout-17b-a16e", "qwen2-vl-2b")
ZOO_BATCH, ZOO_SEQ = 1, 512
def transformer_main_path_phase(torch, rt, arch: str, policy: str) -> dict:
    """A transformer or moe main path at full width and depth: one line
    per stage, the run's peak memory, no launch of any kernel (the
    families run impl="xla", as in the reference); then one train step's
    loss and gradients with remat on, on again and off, held bitwise, and
    the step taken apart (forward, backward, AdamW, each with its peak;
    a moe stack's aux terms)."""
    api, ops = rt["api"], rt["ops"]
    spec = lm_spec(api, arch=arch, reduced=False, policy=policy,
                   corpus=TF_CORPUS, seq_len=TF_SEQ, n0=TF_N0,
                   max_stage_iters=TF_STAGE_ITERS, layers=None,
                   batch=TF_BATCH, eval_rows=TF_EVAL_ROWS, fixed=TF_FIXED)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sess = api.build(spec, device="cuda")
    cfg = sess.model_config
    family = rt["resolve_family"](spec.model, cfg)
    path = family.name
    n_params = sum(t.numel() for t in rt["tree_leaves"](sess.w0))
    f0 = float(sess.objective(sess.w0, sess.eval_data))
    torch.cuda.synchronize()
    emit({"path": path, "arch": cfg.name, "family": family.name,
          "impl": family.impl, "layers": cfg.num_layers,
          "layer_types": sorted(set(cfg.layer_types())),
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "qk_norm": cfg.qk_norm,
          "experts": cfg.num_experts, "experts_per_token":
              cfg.experts_per_token, "moe_d_ff": cfg.moe_d_ff,
          "vocab": cfg.vocab_size, "dtype": str(cfg.dtype),
          "params": n_params, "build_s": time.perf_counter() - t0,
          "f_full_w0": f0, "spec": spec.to_dict()})
    torch.cuda.reset_peak_memory_stats()
    ops.reset_calls()
    tr, stamps, t0, wall = timed_run(torch, sess)
    launches = dict(ops.CALLS)
    peak = torch.cuda.max_memory_allocated()
    rows = stage_lines(sess, tr, stamps, f0, t0, path)
    values = (tr.column("f_window") + tr.column("f_full")
              + [p.extra["f_fast_on_t"] for p in tr.points
                 if "f_fast_on_t" in p.extra])
    summary = {"path": path, "arch": cfg.name, "policy": policy,
               "stages": tr.meta["stages"], "steps": len(tr.points),
               "race_overshoot": tr.meta.get("race_overshoot", 0),
               "host_transfers": tr.meta["host_transfers"],
               "transfers_per_stage": [r["host_transfers"] for r in rows],
               "capture_s": list(sess.engine.race_capture_s),
               "captures": sum(c > 0 for c in sess.engine.race_capture_s),
               "launches": launches, "wall_s": wall,
               "wall_s_per_step": wall / len(tr.points),
               "peak_memory_gb": peak / 1e9,
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
               "f_full_w0": f0, "f_full_final": tr.final().f_full,
               "sim_time": sess.clock.time,
               "data_accesses": sess.clock.data_accesses}
    emit(summary)
    if not all(math.isfinite(v) for v in values):
        fail_later(f"{cfg.name}: non-finite loss in the trace")
    if any(v for k, v in launches.items() if k != "device_while"):
        fail_later(f"{cfg.name}: the {family.name} family launched "
                   f"kernels {launches}")
    if any(r["host_transfers"] != 1 for r in rows):
        fail_later(f"{cfg.name}: pulls per stage "
                   f"{[r['host_transfers'] for r in rows]}, not one")
    params = tr.params
    sess.w0 = None
    del tr
    gc.collect()
    summary["remat"] = remat_bitwise(torch, rt, sess, params, TF_BATCH,
                                     path, family.impl)
    summary["breakdown"] = step_breakdown(torch, rt, sess, params, TF_BATCH,
                                          path, {}, family.impl)
    del sess, params
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def zoo_batch(torch, cfg, seed: int = 0, device: str = "cuda") -> dict:
    """A batch of ZOO_BATCH x ZOO_SEQ uniform random tokens from
    ``seed``; for embedding inputs random ``embeds``, and under M-RoPE
    (3, B, S) positions of a 16 x 32 patch grid (t 0, h, w)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_SEQ + 1),
                        generator=gen, device=device)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = torch.randn((ZOO_BATCH, ZOO_SEQ, cfg.d_model),
                                      generator=gen, device=device)
    if cfg.mrope:
        i = torch.arange(ZOO_SEQ, device=device)
        grid = torch.stack([torch.zeros_like(i), i // 32, i % 32])
        batch["positions"] = grid[:, None].expand(3, ZOO_BATCH, ZOO_SEQ)
    return batch


def zoo_phase(torch, rt, device: str = "cuda") -> list:
    """The rest of the zoo at full width and one layer: ``loss_fn`` and its
    gradients on one batch, twice (the first a warm-up), with the second's
    forward and backward ms, the peak memory, and a finite loss and
    gradient norm; no kernel launched."""
    api, ops, T = rt["api"], rt["ops"], rt["transformer"]
    tree_map, tree_leaves = rt["tree_map"], rt["tree_leaves"]
    rows = []
    for arch in ZOO:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = rt["configs"].get(arch).with_(num_layers=1)
        impl = rt["resolve_family"](api.ModelSpec(arch=arch), cfg).impl
        params = T.init_params(cfg, 0, device=device)
        batch = zoo_batch(torch, cfg, device=device)
        ops.reset_calls()
        for _ in range(2):
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.enable_grad():
                loss, metrics = T.loss_fn(cfg, p, batch, impl=impl)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                grads = torch.autograd.grad(loss, tree_leaves(p))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            del p
        gnorm = float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                     for g in grads)))
        row = {"path": "zoo", "arch": cfg.name, "family": cfg.family,
               "impl": impl, "layers": 1, "d_model": cfg.d_model,
               "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
               "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
               "experts": cfg.num_experts, "vocab": cfg.vocab_size,
               "input_mode": cfg.input_mode, "mrope": cfg.mrope,
               "params": sum(t.numel() for t in tree_leaves(params)),
               "batch": [ZOO_BATCH, ZOO_SEQ], "loss": float(loss.detach()),
               "metrics": {k: float(v.detach()) for k, v in metrics.items()},
               "grad_norm": gnorm, "forward_ms": (t1 - t0) * 1e3,
               "backward_ms": (t2 - t1) * 1e3,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": dict(ops.CALLS)}
        emit(row)
        if not (math.isfinite(row["loss"]) and math.isfinite(gnorm)):
            fail_later(f"zoo {cfg.name}: loss {row['loss']}, gradient "
                       f"norm {gnorm}")
        if any(row["launches"].values()):
            fail_later(f"zoo {cfg.name}: kernels launched "
                       f"{row['launches']}")
        rows.append(row)
        del params, batch, loss, metrics, grads
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# the race on the device (C4).  BENCH_engine.json's setting
# (benchmarks/bench_engine.py): fig3 webspam_like at scale 0.25, n0
# max(128, min(d, n // 8)), bet_fixed (5 inner, 25 final steps), two-track
# (25 final) and batch (30 steps); its engine-side claim is at most one
# pull a stage in every run
ENGINE_DATA, ENGINE_SCALE = "webspam_like", 0.25
WHILE_REPS = 10


def plain_race_loop(ops, ref):
    """``ops.race_loop`` by its plain route on any device: the eager loop,
    one host read a step."""
    def loop(step, carry, hist, s, done, max_iters, keep=()):
        return ops._PlainLoop(ref.race_loop(step, carry, hist, s, done,
                                            max_iters))
    return loop


def while_graph_phase(torch, rt) -> dict:
    """The race's WHILE graph on the card (C4).  (1) quickstart@6 two-track
    (the main path's run, 3a) against the same run with the plain loop on
    the card: the trace and final w bitwise, the trigger steps a stage
    equal, one pull a stage; and against the CPU: the columns equal, f̂
    within RTOL_F.  (2) its longest racing stage alone: the WHILE graph's
    launch timed with CUDA events against the plain loop from the same
    carry, their histories and carries compared (max_abs_err), the
    capture time, and the loop's bound (the steps' operations, counted by
    ``obs.profile`` on meta tensors, at the float32 peak; the inputs read
    once and the carries written once).  (3) BENCH_engine.json's
    ``engine_max_one_transfer_per_stage`` at its own setting."""
    from repro_torch.core.engine import race_step_fns
    from repro_torch.obs import profile
    api, ops, ref = rt["api"], rt["ops"], rt["ref"]
    main = rt["main_two_track"]
    t_phase = time.perf_counter()
    graph_tr, graph_sess = main["trace"], main["session"]
    spec = graph_sess.spec
    real = ops.race_loop
    ops.race_loop = plain_race_loop(ops, ref)
    try:
        eager_sess = api.build(spec, device="cuda")
        ends = {}
        record = eager_sess.engine.stage_callback
        eager_sess.engine.stage_callback = lambda e: (
            ends.__setitem__(e.info.stage, e.params.clone()), record(e))
        t0 = time.perf_counter()
        eager = eager_sess.run()
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
    finally:
        ops.race_loop = real
    differ = bitwise_diff(run_record(graph_tr), run_record(eager))
    if not torch.equal(graph_tr.params, eager.params):
        differ.append("params")
    cpu = api.build(spec, device="cpu").run()
    cpu_cols = [c for c in ("step", "stage", "window", "time", "accesses")
                if cpu.column(c) != graph_tr.column(c)]
    rel = traj_dev(graph_tr, cpu)
    stages = graph_tr.column("stage")
    steps = [stages.count(k) for k in sorted(set(stages))]
    row = {"path": "race", "run": "quickstart@6 two_track",
           "stages": graph_tr.meta["stages"],
           "host_transfers": graph_tr.meta["host_transfers"],
           "steps_per_stage": steps,
           "eager_steps_per_stage": [eager.column("stage").count(k)
                                     for k in sorted(set(stages))],
           "graph_differs_from_eager_loop": differ,
           "graph_wall_s": main["wall_s"], "eager_loop_wall_s": eager_wall,
           "capture_s": list(graph_sess.engine.race_capture_s),
           "cpu_columns_differ": cpu_cols, "card_vs_cpu_max_rel": rel}
    emit(row)
    if differ or cpu_cols or not rel <= RTOL_F or \
            graph_tr.meta["host_transfers"] != graph_tr.meta["stages"]:
        fail_later(f"race on the card: {row}")

    # (2) the longest racing stage, graph against plain loop, timed: it
    # starts from the previous stage's final w (the run's w0 for stage 1)
    # and fresh optimizer states
    stage = max(range(1, len(steps)), key=lambda k: steps[k - 1])
    info = {i.stage: i for i in eager_sess.stage_plan()}[stage]
    w = eager_sess.w0 if stage == 1 else ends[stage - 1]
    ds, pol = eager_sess.dataset, eager_sess.policy
    win_t, win_prev = ds.window(info.n_t), ds.window(info.n_prev)
    full = eager_sess.eval_data if eager_sess.eval_data is not None \
        else ds.window(ds.n)
    opt, obj = eager_sess.optimizer, eager_sess.objective
    M = int(pol.max_stage_iters)

    def fresh():
        hist = torch.zeros((3, M), dtype=torch.float32, device="cuda")
        s = torch.zeros((), dtype=torch.int64, device="cuda")
        done = torch.zeros((), dtype=torch.bool, device="cuda")
        tracks, step = race_step_fns(opt, obj, pol, win_t, win_prev, full,
                                     hist, s)
        carry = step([w.clone(), opt.init(w), w.clone(), opt.init(w)])
        s += 1
        return hist, s, done, tracks, step, carry

    leaves = rt["tree_leaves"]
    hist, s, done, tracks, step, carry = fresh()
    start = [x.clone() for x in leaves(carry)]
    hist0 = hist.clone()
    loop = ops.race_loop(step, carry, hist, s, done, M)
    torch.cuda.synchronize()
    n = int(s)
    g_hist, g_carry = hist.clone(), [x.clone() for x in leaves(loop.carry)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    graph_ms = []
    for _ in range(WHILE_REPS):
        for dst, src in zip(leaves(loop.carry), start):
            dst.copy_(src)
        hist.copy_(hist0)
        s.fill_(1)
        done.zero_()
        ev[0].record()
        loop.launch()
        ev[1].record()
        torch.cuda.synchronize()
        graph_ms.append(ev[0].elapsed_time(ev[1]))
        if int(s) != n or not torch.equal(hist, g_hist):
            fail_later(f"race WHILE graph: a replay differs (s {int(s)} "
                       f"against {n})")
    capture_s = loop.capture_s
    ops.finish_race_loop(loop, n)
    plain_ms = []
    for _ in range(WHILE_REPS):
        p_hist, p_s, p_done, _, p_step, p_carry = fresh()
        torch.cuda.synchronize()
        ev[0].record()
        ref.race_loop(p_step, p_carry, p_hist, p_s, p_done, M)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms.append(ev[0].elapsed_time(ev[1]))
    err = max(float((a - b).abs().max()) for a, b in
              zip([g_hist] + g_carry, [p_hist] + leaves(p_carry)))
    cost = profile.cost(tracks, [w, opt.init(w), w, opt.init(w)], win_t,
                        win_prev, full)
    state_bytes = sum(x.numel() * x.element_size() for x in start)
    in_bytes = sum(x.numel() * x.element_size() for x in full) + state_bytes
    out_bytes = state_bytes + hist.numel() * hist.element_size()
    ops_s = cost["flops"] * (n - 1) / PEAK_F32_FLOPS_S
    bytes_s = (in_bytes + out_bytes) / PEAK_BYTES_S
    wrow = {"path": "race_while_graph", "stage": stage, "n_t": info.n_t,
            "n_prev": info.n_prev, "steps": n, "graph_steps": n - 1,
            "triggered": bool(done), "ms": float(np.median(graph_ms)),
            "plain_ms": float(np.median(plain_ms)),
            "ms_runs": graph_ms, "plain_ms_runs": plain_ms,
            "capture_ms": capture_s * 1e3, "max_abs_err": err,
            "bitwise": err == 0.0, "flops_per_step": cost["flops"],
            "bytes": in_bytes + out_bytes,
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None}
    emit(wrow)
    if err != 0.0:
        emit({"path": "race_while_graph", "note": "the graph and the "
              "eager loop differ", "max_abs_err": err})

    # (3) BENCH_engine.json's engine-side claim at its setting
    methods = rt["methods"]
    ds, eobj, ew0, _ = methods.setup(ENGINE_DATA, ENGINE_SCALE,
                                     device="cuda")
    n0 = max(128, min(ds.d, ds.n // 8))
    per = {}
    for method, kw in (("bet_fixed", dict(inner_steps=5, final_steps=25)),
                       ("bet", dict(final_steps=25)),
                       ("batch", dict(steps=30))):
        tr = methods.run_method(method, ds, eobj, ew0, n0=n0, **kw)
        per[method] = {"host_transfers": tr.meta["host_transfers"],
                       "stages": tr.meta["stages"],
                       "syncs_per_stage": tr.meta["host_transfers"]
                       / tr.meta["stages"]}
    claim = all(v["syncs_per_stage"] <= 1.0 for v in per.values())
    emit({"path": "race_bench_engine", "workload":
          f"fig3/{ENGINE_DATA}", "scale": ENGINE_SCALE, "n": ds.n,
          "d": ds.d, "n0": n0, "methods": per,
          "engine_max_one_transfer_per_stage": claim})
    if not claim:
        fail_later(f"bench_engine setting: engine_max_one_transfer_per_"
                   f"stage is false: {per}")
    emit({"phase": "race", "seconds": time.perf_counter() - t_phase})
    del eager_sess, graph_sess
    rt["main_two_track"] = {"device_while": main["device_while"]}
    return wrow


# 3r: the pre-engine host loops (core/legacy.py) against the engine.
# (a) quickstart@6 (3a's problem and optimizer) under each loop's
# parity-test settings (tests/test_engine.py:32-86, with its rtol 1e-5);
# (b) BENCH_engine.json's setting, with benchmarks/bench_engine.py's
# definitions kept here: fig3 webspam_like at scale 0.25 (ENGINE_DATA,
# ENGINE_SCALE), n0 = max(128, min(d, n // 8)), default_newton, each side
# timed after one warm-up run
LEGACY_RTOL = 1e-5
LEGACY_PARITY = {"run_bet_fixed": dict(inner_steps=4, final_steps=8),
                 "run_two_track": dict(final_steps=8),
                 "run_batch": dict(steps=10)}
# bench_engine.py's DRIVERS: engine side (a run_method name), legacy side;
# and its keywords (``_kwargs``), the same on both sides (run_method takes
# the legacy loop's schedule as ``n0``)
ENGINE_DRIVERS = {"bet_fixed": ("bet_fixed", "run_bet_fixed"),
                  "two_track": ("bet", "run_two_track"),
                  "batch": ("batch", "run_batch")}
ENGINE_KWARGS = {"bet_fixed": dict(inner_steps=5, final_steps=25),
                 "two_track": dict(final_steps=25),
                 "batch": dict(steps=30)}


def legacy_pulls_implied(tr) -> int:
    """The pulls a legacy trace implies: two a fixed-steps step, three a
    racing step and one a final step, one a recorded Batch step."""
    racing = sum("f_fast_on_t" in p.extra for p in tr.points)
    if tr.method == "bet":
        return 2 * len(tr.points)
    return 3 * racing + (len(tr.points) - racing)


def legacy_against_engine(tr_l, tr_e) -> dict:
    """Columns that differ, the (stage, window) sequences, and the largest
    relative gap of f̂_t, f̂ and f̂_t of the fast track."""
    fast = [[p.extra.get("f_fast_on_t") for p in tr.points]
            for tr in (tr_l, tr_e)]
    racing = [[f for f in col if f is not None] for col in fast]
    return {"columns_differ": [c for c in ("step", "stage", "window",
                                           "time", "accesses")
                               if tr_l.column(c) != tr_e.column(c)],
            "expansions_equal": [(p.stage, p.window) for p in tr_l.points]
            == [(p.stage, p.window) for p in tr_e.points],
            "fast_rows_equal": [f is None for f in fast[0]]
            == [f is None for f in fast[1]],
            "max_rel_f": max(traj_dev(tr_l, tr_e),
                             rel_dev(*racing) if racing[0] else 0.0)}


def legacy_phase(torch, rt, scale: float = 6.0,
                 engine_scale: float = ENGINE_SCALE,
                 device: str = "cuda") -> dict:
    """3r: each legacy host loop against the engine (the port's
    deprecated wrapper of the same name) on quickstart@6: the columns and
    the (stage, window) sequence equal, f̂ within LEGACY_RTOL, B1's
    launches in each run what ``methods.kernel_calls`` reads from its
    trace, the loop's host pulls what its trace implies.  Then
    BENCH_engine.json's comparison at its own setting: one line a method
    (both walls, both host-sync counts, the rates, the speedup, parity)
    and the four claims; all but ``engine_faster``, a comparison of wall
    seconds, fail the run at its end.  ``scale``, ``engine_scale`` and
    ``device`` run it small on the CPU."""
    import warnings

    from repro_torch.core import BETSchedule, SimulatedClock, bet, legacy
    from repro_torch.optim import NewtonCG
    api, ops, methods = rt["api"], rt["ops"], rt["methods"]
    card = rt.get("smi", device)
    t_phase = time.perf_counter()

    def run(fn, *args, **kw):
        """One run, with its B1 launches, host pulls and wall seconds."""
        sync(torch, device)
        ops.reset_calls()
        legacy.reset_host_pulls()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            tr = fn(*args, **kw)
        sync(torch, device)
        return tr, {"wall_s": time.perf_counter() - t0,
                    "launches": ops.CALLS.get("linear_value_grad", 0),
                    "implied": methods.kernel_calls(tr),
                    "pulls": legacy.host_pulls()}

    # (a) the parity tests' settings at the main path's shape
    data, _ = quickstart_specs(api, scale)
    ds, obj, w0 = api.convex_problem(data, device=device)
    opt = NewtonCG(hessian_fraction=0.2)
    sched = BETSchedule(n0=128)
    for name, kw in LEGACY_PARITY.items():
        if name != "run_batch":
            kw = dict(kw, schedule=sched)
        tr_l, m_l = run(getattr(legacy, name), ds, opt, obj,
                        clock=SimulatedClock(), w0=w0, **kw)
        tr_e, m_e = run(getattr(bet, name), ds, opt, obj,
                        clock=SimulatedClock(), w0=w0, **kw)
        cmp = legacy_against_engine(tr_l, tr_e)
        row = {"path": "legacy_parity", "loop": name, "n": ds.n, "d": ds.d,
               "steps": len(tr_l.points), "stages": tr_e.meta["stages"],
               **cmp, "legacy": m_l,
               "pulls_implied": legacy_pulls_implied(tr_l),
               "engine": {"wall_s": m_e["wall_s"],
                          "launches": m_e["launches"],
                          "implied": m_e["implied"],
                          "host_transfers": tr_e.meta["host_transfers"]},
               "f_full": [tr_l.final().f_full, tr_e.final().f_full],
               "finite": finite(tr_l) and finite(tr_e), "card": card}
        emit(row)
        if cmp["columns_differ"] or not cmp["expansions_equal"] or \
                not cmp["fast_rows_equal"] or \
                not cmp["max_rel_f"] <= LEGACY_RTOL or not row["finite"] \
                or m_l["launches"] != m_l["implied"] \
                or m_e["launches"] != m_e["implied"] \
                or m_l["pulls"] != row["pulls_implied"]:
            fail_later(f"legacy {name} against the engine: {row}")

    # (b) bench_engine.py at its setting
    ds, eobj, ew0, _ = methods.setup(ENGINE_DATA, engine_scale,
                                     device=device)
    sched = BETSchedule(n0=max(128, min(ds.d, ds.n // 8)))
    report = {}
    for method, (spec_method, loop) in ENGINE_DRIVERS.items():
        legacy_fn = getattr(legacy, loop)

        def legacy_run():
            kw = dict(ENGINE_KWARGS[method])
            if method != "batch":
                kw["schedule"] = sched
            return run(legacy_fn, ds, methods.default_newton(ds), eobj,
                       clock=SimulatedClock(), w0=ew0, **kw)

        def engine_run():
            return run(methods.run_method, spec_method, ds, eobj, ew0,
                       n0=sched.n0, **ENGINE_KWARGS[method])

        legacy_run()                                 # warm-up
        tr_l, m_l = legacy_run()
        engine_run()
        tr_e, m_e = engine_run()
        pulls = m_l["pulls"]
        stages = tr_e.meta["stages"]
        transfers = tr_e.meta["host_transfers"]
        # syncs per inner-stage step: the two-track final phase pulls once
        # a step, so it is counted apart from the racing steps
        n_inner = sum("f_fast_on_t" in p.extra for p in tr_l.points) \
            if method == "two_track" else len(tr_l.points)
        n_tail = len(tr_l.points) - n_inner
        f_l, f_e = tr_l.final().f_full, tr_e.final().f_full
        v = {"legacy": {"wall_s": m_l["wall_s"], "host_syncs": pulls,
                        "steps": len(tr_l.points),
                        "syncs_per_step": pulls / len(tr_l.points),
                        "syncs_per_inner_step":
                            (pulls - n_tail) / max(1, n_inner),
                        "launches": m_l["launches"],
                        "launches_implied": m_l["implied"],
                        "final_f": f_l},
             "engine": {"wall_s": m_e["wall_s"], "host_syncs": transfers,
                        "steps": len(tr_e.points), "stages": stages,
                        "syncs_per_stage": transfers / stages,
                        "launches": m_e["launches"],
                        "launches_implied": m_e["implied"],
                        "final_f": f_e},
             "speedup": m_l["wall_s"] / m_e["wall_s"],
             "sync_reduction": pulls / max(1, transfers),
             "parity": abs(f_e - f_l) <= 1e-3 * max(1.0, abs(f_l))}
        report[method] = v
        emit({"path": "legacy_bench_engine", "method": method,
              "workload": f"fig3/{ENGINE_DATA}", "scale": engine_scale,
              "n": ds.n, "d": ds.d, "n0": sched.n0, **v, "card": card})
        if m_l["launches"] != m_l["implied"] or \
                m_e["launches"] != m_e["implied"]:
            fail_later(f"bench_engine {method}: B1 launches differ from "
                       f"the traces' counts: {v}")
    claims = {
        "engine_max_one_transfer_per_stage": all(
            v["engine"]["syncs_per_stage"] <= 1.0 for v in report.values()),
        "legacy_at_least_two_syncs_per_step": all(
            v["legacy"]["syncs_per_inner_step"] >= 2.0
            for k, v in report.items() if k != "batch"),
        "engine_faster": all(v["speedup"] > 1.0 for v in report.values()),
        "parity": all(v["parity"] for v in report.values()),
    }
    seconds = time.perf_counter() - t_phase
    emit({"path": "legacy_bench_engine", "claims": claims,
          "speedup": {k: v["speedup"] for k, v in report.items()},
          "phase_s": seconds, "card": card})
    for claim in ("engine_max_one_transfer_per_stage",
                  "legacy_at_least_two_syncs_per_step", "parity"):
        if not claims[claim]:
            fail_later(f"bench_engine setting: {claim} is false: {report}")
    return {"methods": report, "claims": claims, "seconds": seconds}


def profiler_trace_summary(path: Path) -> dict:
    """The Chrome trace ``torch.profiler`` wrote around a run: its size,
    its events and how many of them are the card's kernels."""
    if not path.is_file():
        return {"written": False, "events": 0, "kernel_events": 0}
    events = json.loads(path.read_text()).get("traceEvents", [])
    return {"written": True, "bytes": path.stat().st_size,
            "events": len(events),
            "kernel_events": sum(e.get("cat") == "kernel" for e in events)}


def obs_phase(torch, rt, scale: float = 6.0, device: str = "cuda") -> dict:
    """Observability on the card.  quickstart@6 two-track on the plane
    under ``ObsSpec(enabled, dir, chrome_trace, profile, health,
    jax_profiler_dir)``: the RunReport's claims all true
    (``le_one_transfer_per_stage`` among them), the run bitwise the same
    run unobserved, ``torch.profiler``'s Chrome trace written with the
    card's kernels in it, one ``profile.stage``
    a stage with its FLOPs and roofline seconds beside the stage's
    measured compute seconds, the files written.  Then BENCH_dist.json's
    setting under fleet and health obs at 4 simulated hosts: one lane file
    a host and the driver's, the merged trace causal at every barrier,
    health's detections, the claims over the merged stream.  ``scale``
    and ``device`` run it small on the CPU."""
    api = rt["api"]
    t_phase = time.perf_counter()
    data, base = quickstart_specs(api, scale)
    spec = api.RunSpec(name="obs_quickstart", policy=api.PolicySpec(
        "two_track", {"final_steps": 20}),
        **dict(base, data=data.replace(plane="plane")))
    off = api.build(spec, device=device).run()
    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as d:
        obs = api.ObsSpec(enabled=True, dir=str(Path(d) / "obs"),
                          chrome_trace=True, profile=True, health=True,
                          jax_profiler_dir=str(Path(d) / "profiler"))
        sess = api.build(spec.replace(obs=obs), device=device)
        t0 = time.perf_counter()
        tr = sess.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        claims = sess.run_report().claims()
        files = sorted(p.name for p in (Path(d) / "obs").iterdir())
        profiler = profiler_trace_summary(Path(d) / "profiler" / "trace.json")
    differ = bitwise_diff(run_record(off), run_record(tr))
    if not torch.equal(off.params, tr.params):
        differ.append("params")
    events = sess.recorder.event_dicts()
    compute = collections.defaultdict(float)
    for e in events:
        if e["name"] == "stage.compute":
            compute[e["tags"].get("stage")] += e["dur"]
    prof = [{"stage": e["fields"]["stage"], "n_t": e["fields"]["n_t"],
             "callable": e["fields"]["callable"],
             "flops": e["fields"].get("flops"),
             "bytes": e["fields"].get("bytes"),
             "roofline_us": e["fields"].get("roofline_us"),
             "bottleneck": e["fields"].get("bottleneck"),
             "error": e["fields"].get("error"),
             "stage_compute_s": compute.get(e["fields"]["stage"])}
            for e in events if e["name"] == "profile.stage"]
    health = sess.health_report()
    row = {"path": "obs", "run": "quickstart@6 two_track plane",
           "claims": claims, "wall_s": wall,
           "unobserved_differs": differ, "events": len(events),
           "files": files, "profile": prof, "profiler_trace": profiler,
           "healthy": health.healthy,
           "detections": [d.to_dict() for d in health.detections]}
    emit(row)
    if not profiler["events"] or (device == "cuda"
                                  and not profiler["kernel_events"]):
        fail_later(f"obs quickstart@6: the profiler's trace {profiler}")
    if not all(v is True for v in claims.values()):
        fail_later(f"obs quickstart@6: claims {claims}")
    if differ:
        fail_later(f"obs quickstart@6: observed run differs from the "
                   f"unobserved one in {differ}")
    if len(prof) != tr.meta["stages"] or \
            any(p["error"] or not p["flops"] for p in prof):
        fail_later(f"obs quickstart@6: profile events {prof}")
    want = {"events.jsonl", "trace.json", "report.json", "report.txt",
            "health.json", "health.txt"}
    if not want <= set(files):
        fail_later(f"obs quickstart@6: files {files}")

    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as workdir:
        inner, final = DIST_STEPS
        dist_data, n0 = dict(DIST_DATA), DIST_N0
        if scale != 6.0:            # small: 512 rows, shards of 32, n0 64
            dist_data.update(scale=DIST_DATA["scale"] / 4, shard_size=32)
            n0 = 64
        bench = api.RunSpec(
            name="bench_dist_obs", data=api.DataSpec(
                lam=1e-3, plane="plane", store="memmap", workdir=workdir,
                **dist_data),
            policy=api.PolicySpec("fixed_steps", {"inner_steps": inner,
                                                  "final_steps": final}),
            optimizer=api.OptimizerSpec("newton_cg",
                                        {"hessian_fraction": 1.0}),
            schedule=api.ScheduleSpec(n0=n0),
            topology=api.TopologySpec(hosts=HOSTS),
            obs=api.ObsSpec(enabled=True, fleet=True, health=True,
                            dir=str(Path(workdir) / "obs"),
                            chrome_trace=True))
        fsess = api.build(bench, device=device)
        t0 = time.perf_counter()
        ftr = fsess.run()
        fwall = time.perf_counter() - t0
        lanes = sorted(str(k) for k in ftr.meta["obs_files"]["lanes"])
        ft = fsess.fleet_trace()
        barriers = sorted({e["fields"]["stage"] for e in ft.events
                           if e["name"] == "fleet.barrier"})
        causal = True
        for k in barriers:
            last = max(i for i, e in enumerate(ft.events)
                       if e["name"] == "fleet.barrier"
                       and e["fields"]["stage"] == k)
            seen = {e["lane"] for e in ft.events[:last + 1]
                    if e["name"] == "fleet.barrier"
                    and e["fields"]["stage"] == k}
            causal &= seen == {"driver", *range(HOSTS)}
        seqs: dict = {}
        for e in ft.events:
            causal &= e["lane_seq"] > seqs.get(e["lane"], -1)
            seqs[e["lane"]] = e["lane_seq"]
        fclaims = fsess.run_report().claims()
        fhealth = fsess.health_report()
        loads = {h: sum(1 for e in ft.events if e["lane"] == h
                        and e["name"] == "meter.load")
                 for h in range(HOSTS)}
        frow = {"path": "obs_fleet", "run": "bench_dist", "hosts": HOSTS,
                "n": fsess.dataset.n, "wall_s": fwall, "lanes": lanes,
                "merged_events": len(ft.events), "barriers": barriers,
                "causal_at_every_barrier": causal,
                "meter_loads_per_lane": loads, "claims": fclaims,
                "offsets_s": {str(k): v.get("offset_s")
                              for k, v in ft.hosts.items()},
                "healthy": fhealth.healthy,
                "detections": [d.to_dict() for d in fhealth.detections]}
        emit(frow)
        if lanes != sorted(["0", "1", "2", "3", "driver"]) or not causal \
                or not all(loads.values()) or \
                not fclaims["per_host_loads_are_owned_slice"] or \
                not fclaims["each_example_loaded_once"]:
            fail_later(f"obs fleet bench_dist: {frow}")
        del fsess
    emit({"phase": "obs", "seconds": time.perf_counter() - t_phase})
    return row


def sweep_phase(torch, rt, device: str = "cuda", names=None) -> list:
    """BENCH_workloads.json's matrix: the eleven presets (or ``names``)
    through the port's sweep (``repro_torch.workloads.sweep``: each preset
    observed, its claims recomputed from its events, its checkpoints and
    logs in a temporary directory), one line a preset; ``matrix_green``
    (every claim of every preset true) must hold."""
    wl = rt["workloads"]
    names = names or [p.name for p in wl.PRESETS]
    t0 = time.perf_counter()
    rows = []

    def line(res):
        row = {"path": "preset", **res.to_dict()}
        emit(row)
        rows.append(row)
    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as d:
        wl.sweep(names, workdir=d, device=device, progress=line)
    green = all(r["ok"] for r in rows)
    emit({"path": "sweep", "presets": len(rows), "matrix_green": green,
          "seconds": time.perf_counter() - t0})
    if not green or len(rows) != len(names):
        fail_later(f"sweep: matrix not green: "
                   f"{[(r['name'], r['claims'], r['error']) for r in rows if not r['ok']]}")
    return rows


# serving (A11's serve half): prefill and decode at full width, the
# closed loop, the bench's A/B.  3l: recurrentgemma-9b, one (rec, rec,
# attn) super-block, 4 prompts of 2,560 tokens — past the 2,048 local
# window, so the prefill's KV ring has wrapped (slot p % 2,048) before
# decoding starts.  2,560 rather than 2,100: the xla prefill's chunked
# attention takes whole 512-token query chunks (the reference asserts
# S % 512 == 0), and a prompt of 2,561 tokens is prefilled with
# impl="pallas" (B2 takes any length) as the consistency reference
SERVE_HYBRID = dict(batch=4, prompt=2560, decode=32)
# the reference test's bound for the hybrid's prefill-to-decode
# consistency in bfloat16 (tests/test_serving.py:28,46), relative to the
# largest logit; also the pallas prefill's logits against the xla one's
RTOL_SERVE_HYBRID = 0.03
# qwen3-0.6b at full width and depth: generate, 8 x 64 prompts, 64 tokens
SERVE_DENSE = dict(batch=8, prompt=64, gen=64)
# one full-width layer each, decode against a prefill of one more token:
# float32 at the reference test's exactness bound, 1e-4 relative; bfloat16
# at the hybrid's 0.03 (cuBLAS picks a GEMM kernel by the row count, so a
# 256-row prefill and a 4-row decode round differently in bfloat16)
SERVE_LAYERS = (("falcon-mamba-7b", {}),
                ("granite-moe-1b-a400m", {"capacity_factor": 8.0}))
SERVE_LAYER = dict(batch=4, prompt=64)
RTOL_SERVE_F32 = 1e-4
# 3m: the closed loop at full width, falcon-mamba-7b at depth 1 (each
# stage publishes a checkpoint of params and AdamW moments, 6.4 GB at one
# layer); ServeSpec(requests_per_tick=8, prompt_len=64): 65 new tokens,
# training rows of 128; capacity 256, shards of 16, n0 32, growth 2,
# traffic_driven (1 inner step a check, 2 final), adamw_lm lr 1e-3 batch
# 8, a probe of 16 rows, CheckpointSpec(keep=2, every=1), swap on
SERVE_LOOP = dict(arch="falcon-mamba-7b", reduced=False, layers=1,
                  capacity=256, seq_len=128, prompt=64, rpt=8, n0=32,
                  shard=16, eval_rows=16, batch=8)
# 3m': BENCH_serve.json's setting (benchmarks/bench_serve.py's defaults):
# qwen3-0.6b reduced, capacity 256, rows of 33, prompts of 16
SERVE_BENCH = dict(arch="qwen3-0.6b", reduced=True, layers=None,
                   capacity=256, seq_len=32, prompt=16, rpt=8, n0=32,
                   shard=16, eval_rows=16, batch=8)
# card against CPU: the reduced hybrid's serving in float32 and a reduced
# closed loop (the bench's setting at capacity 64)
SERVE_CPU_LOOP = dict(SERVE_BENCH, capacity=64, dtype="float32")


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def logits_rel(a, b) -> float:
    """max |a - b| over max |b|: logits against a reference's."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def serve_tokens(torch, cfg, batch: int, length: int, seed: int, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, length), dtype=np.int64)).to(device)


def peak_gb(torch, device: str):
    return torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" \
        else None


def reset_peak(torch, device: str) -> None:
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def hybrid_serving(torch, rt, cfg, *, batch: int, prompt: int, decode: int,
                   device: str = "cuda") -> dict:
    """The hybrid's serving at ``cfg``'s width: prefill of ``prompt``
    tokens with impl="xla" and impl="pallas" (B2 launched once per attn
    layer, B4 never: the reference's prefill passes no impl to the
    Griffin block, transformer.py:340), their logits within the bound;
    one decode step from the xla prefill's cache against the last logits
    of a pallas prefill of one more token; then greedy decoding to
    ``decode`` steps, the ring buffer wrapped."""
    T, ops = rt["transformer"], rt["ops"]
    reset_peak(torch, device)
    params = T.init_params(cfg, 0, device=device)
    tok = serve_tokens(torch, cfg, batch, prompt + 1, 11, device)
    cache_len = prompt + decode
    n_attn = cfg.layer_types().count("attn")
    row = {"path": "serving", "arch": cfg.name, "layers": cfg.num_layers,
           "batch": batch, "prompt": prompt, "decode": decode,
           "window": cfg.local_window}
    runs = {}
    for impl, length in (("xla", prompt), ("pallas", prompt),
                         ("pallas", prompt + 1)):
        ops.reset_calls()
        sync(torch, device)
        t0 = time.perf_counter()
        logits, cache = T.prefill_step(cfg, params,
                                       {"tokens": tok[:, :length]},
                                       impl=impl, cache_len=cache_len)
        sync(torch, device)
        runs[(impl, length)] = (logits, cache)
        row[f"prefill_{impl}_{length}_s"] = time.perf_counter() - t0
        row[f"launches_{impl}_{length}"] = dict(ops.CALLS)
    lx, cache = runs[("xla", prompt)]
    lp = runs[("pallas", prompt)][0]
    lref = runs[("pallas", prompt + 1)][0]
    del runs
    row["ring_slots"] = int(cache["stack_attn"]["k"].shape[2])
    row["rel_pallas_vs_xla"] = logits_rel(lp, lx)
    ops.reset_calls()
    t0 = time.perf_counter()
    logits, cache = T.decode_step(cfg, params, cache, {
        "tokens": tok[:, prompt:prompt + 1], "position": prompt})
    row["rel_decode_vs_prefill"] = logits_rel(logits, lref)
    finite = bool(torch.isfinite(logits).all())
    for i in range(1, decode):
        nxt = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        logits, cache = T.decode_step(cfg, params, cache, {
            "tokens": nxt[:, None], "position": prompt + i})
    sync(torch, device)
    row["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / decode
    row["launches_decode"] = dict(ops.CALLS)
    finite = finite and bool(torch.isfinite(logits).all())
    row.update(finite=finite, rtol=RTOL_SERVE_HYBRID,
               peak_memory_gb=peak_gb(torch, device))
    emit(row)
    want_pallas = {"flash_attention": n_attn} if n_attn else {}
    if row[f"launches_pallas_{prompt}"] != want_pallas or \
            row[f"launches_pallas_{prompt + 1}"] != want_pallas or \
            row[f"launches_xla_{prompt}"] or row["launches_decode"]:
        fail_later(f"serving {cfg.name}: launches {row}")
    if not (finite and row["rel_pallas_vs_xla"] < RTOL_SERVE_HYBRID
            and row["rel_decode_vs_prefill"] < RTOL_SERVE_HYBRID):
        fail_later(f"serving {cfg.name}: consistency {row}")
    if prompt > cfg.local_window and row["ring_slots"] != cfg.local_window:
        fail_later(f"serving {cfg.name}: ring of {row['ring_slots']} slots")
    del params, cache, logits
    return row


def dense_generate(torch, rt, cfg, *, batch: int, prompt: int, gen: int,
                   device: str = "cuda") -> dict:
    """``launch/serve.generate`` greedily at ``cfg``'s width and depth
    (after a warm-up call): prefill s, decode ms a token, tokens/s, peak;
    the tokens in the vocabulary and the same on a second call."""
    T, serve = rt["transformer"], rt["serve"]
    reset_peak(torch, device)
    params = T.init_params(cfg, 0, device=device)
    prompts = serve_tokens(torch, cfg, batch, prompt, 12, device)
    serve.generate(cfg, params, prompts, gen_tokens=2)
    sync(torch, device)
    t0 = time.perf_counter()
    T.prefill_step(cfg, params, {"tokens": prompts}, cache_len=prompt + gen)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = serve.generate(cfg, params, prompts, gen_tokens=gen)
    sync(torch, device)
    wall = time.perf_counter() - t0
    again = serve.generate(cfg, params, prompts, gen_tokens=gen)
    row = {"path": "serving_generate", "arch": cfg.name,
           "layers": cfg.num_layers, "batch": batch, "prompt": prompt,
           "gen": gen, "prefill_s": prefill_s, "generate_s": wall,
           "decode_ms_per_token": (wall - prefill_s) * 1e3 / gen,
           "tokens_per_s": batch * gen / wall,
           "deterministic": bool(torch.equal(toks, again)),
           "in_vocab": bool(int(toks.max()) < cfg.vocab_size
                            and int(toks.min()) >= 0),
           "shape": list(toks.shape),
           "peak_memory_gb": peak_gb(torch, device)}
    emit(row)
    if not (row["deterministic"] and row["in_vocab"]
            and row["shape"] == [batch, gen]):
        fail_later(f"generate {cfg.name}: {row}")
    return row


def layer_consistency(torch, rt, cfg, *, batch: int, prompt: int,
                      device: str = "cuda") -> dict:
    """Decode against prefill at ``cfg``'s width: one decode step from a
    prefill of ``prompt`` tokens against the last logits of a prefill of
    ``prompt`` + 1, in float32 and in bfloat16."""
    T = rt["transformer"]
    row = {"path": "serving_layer", "arch": cfg.name,
           "layers": cfg.num_layers, "batch": batch, "prompt": prompt}
    for name, dtype, bound in (("float32", torch.float32, RTOL_SERVE_F32),
                               ("bfloat16", torch.bfloat16,
                                RTOL_SERVE_HYBRID)):
        c = cfg.with_(dtype=dtype)
        params = T.init_params(c, 0, device=device)
        tok = serve_tokens(torch, c, batch, prompt + 1, 13, device)
        ref, _ = T.prefill_step(c, params, {"tokens": tok},
                                cache_len=prompt + 8)
        _, cache = T.prefill_step(c, params, {"tokens": tok[:, :prompt]},
                                  cache_len=prompt + 8)
        dec, _ = T.decode_step(c, params, cache, {
            "tokens": tok[:, prompt:prompt + 1], "position": prompt})
        row[f"rel_{name}"] = logits_rel(dec, ref)
        row[f"rtol_{name}"] = bound
        if not row[f"rel_{name}"] < bound:
            fail_later(f"serving layer {cfg.name} {name}: "
                       f"{row[f'rel_{name}']} >= {bound}")
        del params, cache
    emit(row)
    return row


def serving_phase(torch, rt, device: str = "cuda", reduced: bool = False
                  ) -> dict:
    """3l: the hybrid's prefill and decode, qwen3-0.6b's generate, and one
    layer each of falcon-mamba-7b and granite-moe-1b-a400m, at full width
    (``reduced``: the reduced configs and small shapes, for the CPU)."""
    configs = rt["configs"]

    def config(arch, layers=None):
        cfg = configs.get(arch)
        if reduced:
            return configs.reduced(cfg)
        return cfg if layers is None else cfg.with_(num_layers=layers)

    small = dict(batch=2, prompt=128, decode=4) if reduced else SERVE_HYBRID
    out = {"hybrid": hybrid_serving(torch, rt, config("recurrentgemma-9b", 3),
                                    device=device, **small)}
    dense = dict(batch=2, prompt=16, gen=4) if reduced else SERVE_DENSE
    out["generate"] = dense_generate(torch, rt, config("qwen3-0.6b"),
                                     device=device, **dense)
    layer = dict(batch=2, prompt=16) if reduced else SERVE_LAYER
    out["layers"] = [layer_consistency(
        torch, rt, config(arch, 1).with_(**kw), device=device, **layer)
        for arch, kw in SERVE_LAYERS]
    return out


def serve_spec(api, ckpt_dir, *, arch: str, reduced: bool, layers, capacity,
               seq_len, prompt, rpt, n0, shard, eval_rows, batch,
               swap: bool = True, dtype: str | None = None):
    """The closed loop's RunSpec (``benchmarks/bench_serve.py``'s
    ``_spec`` with keep=2): traffic_driven (1 inner step, 2 final),
    adamw_lm at lr 1e-3, growth 2 with a batch-cost clock."""
    overrides = {}
    if layers is not None:
        overrides["num_layers"] = layers
    if dtype is not None:
        overrides["dtype"] = dtype
    return api.RunSpec(
        name="serve_loop",
        data=api.DataSpec(kind="lm", plane="plane", corpus_size=capacity,
                          seq_len=seq_len, eval_rows=eval_rows,
                          shard_size=shard, seed=0),
        policy=api.PolicySpec("traffic_driven",
                              {"inner_steps": 1, "final_steps": 2}),
        optimizer=api.OptimizerSpec("adamw_lm",
                                    {"lr": 1e-3, "batch_size": batch}),
        schedule=api.ScheduleSpec(n0=n0, growth=2.0, step_cost="batch"),
        checkpoint=api.CheckpointSpec(directory=str(ckpt_dir), keep=2,
                                      every=1),
        serve=api.ServeSpec(enabled=True, requests_per_tick=rpt,
                            prompt_len=prompt, capacity=capacity,
                            swap=swap),
        model=api.ModelSpec(arch=arch, reduced=reduced, overrides=overrides))


def loop_resume(torch, rt, loop, ckpt_dir) -> dict:
    """``benchmarks/bench_serve.py``'s resume contract over the closed
    request log: the last published params bitwise the engine's final
    ones, the clock saved at the final boundary the run's, the window
    re-landed within the saved cursor, the meters restored."""
    from repro_torch.data.plane import StreamingDataset
    from repro_torch.elastic.checkpoint import (load_stage_checkpoint,
                                                peek_stage_meta)
    latest = sorted(Path(ckpt_dir).glob("stage_*.npz"))[-1].with_suffix("")
    restored = load_stage_checkpoint(latest, loop.trace.params, None)
    same = all(torch.equal(a, b) for a, b in zip(
        rt["tree_leaves"](restored.params),
        rt["tree_leaves"](loop.trace.params)))
    meta = peek_stage_meta(latest)
    with StreamingDataset([loop.store], masked=True,
                          device=loop.device) as ds:
        rewarm = restored.restore_dataset(ds)
        meters_ok = ds.meter.snapshot() == meta["dataset"]["meter"]
    return {"params_bitwise_equal": bool(same),
            "clock_exact": meta["clock"] == loop.final_clock,
            "cursor_ok": True, "meters_restored": bool(meters_ok),
            "rewarm": rewarm,
            "checkpoint_stage": restored.meta["cursor"]["stage"],
            "checkpoint_n_t": restored.n_t}


def loop_row(rep: dict) -> dict:
    """A closed-loop report's line: the counts, the server's metrics, the
    staleness, the meter, the stage table's time split."""
    table = rep["stage_table"]
    return {"ticks": rep["ticks"], "requests": rep["requests"],
            "logged": rep["logged_examples"], "stages": rep["stages"],
            "holds": rep["holds"], "steps": sum(r["steps"] for r in table),
            "checkpoints": rep["checkpoints"], "server": rep["server"],
            "serve_wall_s": rep["serve_wall_s"],
            "tokens_per_s_wall": rep["tokens_per_s_wall"],
            "warm_staleness": rep.get("staleness", {}).get("warm_samples"),
            "max_warm_staleness": rep.get("staleness", {}).get("max_warm"),
            "meter": {k: rep["data_plane"][k] for k in (
                "examples_loaded", "examples_uploaded", "examples_accessed",
                "loads", "uploads")},
            "clock": rep["clock"],
            "compute_s": sum(r["compute_s"] for r in table),
            "checkpoint_write_s": [r["checkpoint_s"] for r in table],
            "acquire_s": sum(r["acquire_s"] for r in table)}


def loop_claims(swap_rep: dict, base_rep: dict | None, resume: dict) -> dict:
    """BENCH_serve.json's claims (benchmarks/bench_serve.py): the six that
    need no A/B, and with ``base_rep`` the throughput under swap."""
    n = swap_rep["logged_examples"]
    meter = swap_rep["data_plane"]
    reps = [swap_rep] + ([base_rep] if base_rep is not None else [])
    claims = {
        "swap_latency_bounded":
            swap_rep["server"]["swap_latency_max_s"] < 5.0,
        "staleness_warm": swap_rep["staleness"]["max_warm"] <= 1,
        "swapped_repeatedly": swap_rep["server"]["swap_count"] >= 2,
        "no_dropped_requests": all(
            r["server"]["requests_completed"]
            == r["server"]["requests_started"] for r in reps),
        "single_upload": (meter["examples_loaded"] == n
                          and meter["examples_uploaded"] == n),
        "resume_bit_compatible": bool(
            resume["params_bitwise_equal"] and resume["clock_exact"]
            and resume["cursor_ok"] and resume["meters_restored"]),
    }
    if base_rep is not None:
        ratio = swap_rep["tokens_per_s_wall"] / max(
            base_rep["tokens_per_s_wall"], 1e-9)
        claims["throughput_under_swap"] = ratio >= 0.8
    return claims


def serve_loop_phase(torch, rt, setting: dict = SERVE_LOOP,
                     device: str = "cuda") -> dict:
    """3m: the closed loop (``repro_torch.serve.build_loop``) on
    ``setting``, launch counts zeroed just before ``run`` and read just
    after: B3 launched 3 x layers x steps (each train step's forward and
    its rematerialization, each step's f̂ probe; the server decodes with
    impl="xla"); BENCH_serve.json's six claims that need no A/B."""
    api, ops, serve = rt["api"], rt["ops"], rt["serve_pkg"]
    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as d:
        spec = serve_spec(api, d, **setting)
        reset_peak(torch, device)
        t0 = time.perf_counter()
        loop = serve.build_loop(spec, device=device)
        build_s = time.perf_counter() - t0
        ops.reset_calls()
        t0 = time.perf_counter()
        rep = loop.run()
        sync(torch, device)
        wall = time.perf_counter() - t0
        launches = dict(ops.CALLS)
        resume = loop_resume(torch, rt, loop, d)
        n_layers = loop.cfg.num_layers
        row = {"path": "serve_loop", "arch": loop.cfg.name,
               "layers": n_layers, "d_model": loop.cfg.d_model,
               "family": loop.family.name, "build_s": build_s,
               "wall_s": wall, **loop_row(rep), "launches": launches,
               "peak_memory_gb": peak_gb(torch, device), "resume": resume,
               "f_full_first": loop.trace.points[0].f_full,
               "f_full_final": loop.trace.final().f_full}
        kernels = loop.family.kernels
        want = {k: 3 * n_layers * row["steps"] for k in kernels} \
            if loop.family.name == "mamba" else None
        row["launches_implied"] = want
        row["claims"] = loop_claims(rep, None, resume)
        emit(row)
        if want is not None and {k: launches.get(k, 0)
                                 for k in kernels} != want:
            fail_later(f"serve loop {loop.cfg.name}: launches {launches}, "
                       f"implied {want}")
        if not all(row["claims"].values()):
            fail_later(f"serve loop {loop.cfg.name}: claims {row['claims']}")
        if not math.isfinite(row["f_full_final"]):
            fail_later(f"serve loop {loop.cfg.name}: f̂ {row['f_full_final']}")
        del loop
    gc.collect()
    return row


def warm_serving(torch, loop) -> None:
    """Run the server's prefill and decode once outside the timed loop
    (``bench_serve.py``'s ``_warmup``), so the A/B measures swapping."""
    from repro_torch.serve.swap import serve_kernels
    prefill, decode = serve_kernels(loop.cfg, loop.spec.data.seq_len + 1)
    s = loop.spec.serve
    prompts = torch.zeros((s.requests_per_tick, s.prompt_len),
                          dtype=torch.long, device=loop.device)
    _, cache = prefill(loop.params0, {"tokens": prompts})
    decode(loop.params0, cache, {"tokens": prompts[:, :1],
                                 "position": s.prompt_len})
    sync(torch, loop.device.type)


def serve_ab_phase(torch, rt, setting: dict = SERVE_BENCH,
                   device: str = "cuda") -> dict:
    """3m': BENCH_serve.json's A/B on its own setting: the same seeded
    traffic with and without hot swap, the kernels warmed first; all seven
    claims."""
    api, serve = rt["api"], rt["serve_pkg"]
    reps, resume = {}, None
    for mode, swap in (("no_swap", False), ("swap", True)):
        with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as d:
            loop = serve.build_loop(serve_spec(api, d, swap=swap, **setting),
                                    device=device)
            warm_serving(torch, loop)
            reps[mode] = loop.run()
            if swap:
                resume = loop_resume(torch, rt, loop, d)
        emit({"path": "serve_ab", "mode": mode, **loop_row(reps[mode])})
    ratio = reps["swap"]["tokens_per_s_wall"] / max(
        reps["no_swap"]["tokens_per_s_wall"], 1e-9)
    claims = loop_claims(reps["swap"], reps["no_swap"], resume)
    row = {"path": "serve_ab", "throughput_ratio": ratio, "claims": claims,
           "resume": resume}
    emit(row)
    if not all(claims.values()):
        fail_later(f"serve A/B: claims {claims}")
    return row


def serve_card_vs_cpu_phase(torch, rt, card: str = "cuda") -> dict:
    """The reduced hybrid's prefill (both impls) and decode logits in
    float32 on the card and the CPU from the same parameters, within
    RTOL_F; then a reduced closed loop on both from the same weights:
    every count of the report equal and the logged tokens equal
    (``card``: the device held to the CPU)."""
    T, api, serve = rt["transformer"], rt["api"], rt["serve_pkg"]
    cfg = rt["configs"].reduced(rt["configs"].get("recurrentgemma-9b")) \
        .with_(dtype=torch.float32)
    p_cpu = T.init_params(cfg, 0, device="cpu")
    p_gpu = rt["tree_map"](lambda t: t.to(card), p_cpu)
    tok = serve_tokens(torch, cfg, 2, 33, 14, "cpu")
    rel = {}
    for impl in ("xla", "pallas"):
        out = {}
        for dev, p in (("cpu", p_cpu), (card, p_gpu)):
            t = tok.to(dev)
            logits, cache = T.prefill_step(cfg, p, {"tokens": t[:, :32]},
                                           impl=impl, cache_len=40)
            dec, _ = T.decode_step(cfg, p, cache, {"tokens": t[:, 32:],
                                                   "position": 32})
            out[dev] = (logits.cpu(), dec.cpu())
        rel[f"prefill_{impl}"] = logits_rel(out[card][0], out["cpu"][0])
        rel[f"decode_{impl}"] = logits_rel(out[card][1], out["cpu"][1])
    row = {"card_vs_cpu": "serving", "arch": cfg.name, "rel": rel,
           "rtol": RTOL_F}
    reps, corpora = {}, {}
    with tempfile.TemporaryDirectory(dir=rt["build_dir"]) as d:
        cpu_loop = serve.build_loop(serve_spec(
            api, Path(d) / "cpu", **SERVE_CPU_LOOP), device="cpu")
        gpu_loop = serve.build_loop(
            serve_spec(api, Path(d) / "card", **SERVE_CPU_LOOP),
            device=card,
            params0=rt["tree_map"](lambda t: t.to(card), cpu_loop.params0))
        for dev, loop in (("cpu", cpu_loop), ("card", gpu_loop)):
            reps[dev] = loop_row(loop.run())
            corpora[dev] = loop.store.prefix(loop.store.num_examples)
    keys = ("ticks", "requests", "logged", "stages", "holds", "steps",
            "checkpoints", "meter", "clock")
    row["loop_columns_equal"] = all(reps["cpu"][k] == reps["card"][k]
                                    for k in keys)
    row["loop_tokens_equal"] = bool(np.array_equal(corpora["cpu"],
                                                   corpora["card"]))
    if not row["loop_tokens_equal"] and \
            corpora["cpu"].shape == corpora["card"].shape:
        diff = np.argwhere(corpora["cpu"] != corpora["card"])
        row["first_token_difference"] = diff[0].tolist()
    emit(row)
    if not all(v <= RTOL_F for v in rel.values()):
        fail_later(f"serving card/CPU logits {rel}")
    if not (row["loop_columns_equal"] and row["loop_tokens_equal"]):
        fail_later(f"serve loop card/CPU {row} {reps}")
    return row


# SASS opcodes that show which units a kernel runs on: HGMMA (wgmma),
# UTMALDG (TMA loads), SYNCS (mbarrier waits), HMMA and LDSM (mma.sync
# and ldmatrix), MUFU.EX2 (the SFU's exp2)
# ------------------------------------------------------------ tiered corpus
# 3p: BET when disk access is constrained.  w8a_like's rows (300 float32
# features and a label, 1,204 bytes) at 2^22 rows, about 5.05 GB, in a
# memory store of 256 shards, under an HBM budget of a quarter of it: the
# hot window holds 2^20 rows, and the stages beyond it are swept in four
# (the final stage) and two disjoint segments.  The inner steps are many so
# that each hot segment's compute outlasts the staging of the next one
# from the store (the BENCH_scale claims ask that half of it hide).
TIER_N = 1 << 22
TIER_SHARD = 16384
TIER_N0 = 1 << 16
TIER_RATIO = 4
TIER_POLICY = {"inner_steps": 200, "final_steps": 800}
# the full-budget run and the untiered plane it is held to bitwise, and
# the kill-and-resume at 2^18 rows: shorter runs
TIER_SHORT = {"inner_steps": 20, "final_steps": 40}
TIER_RESUME_N = 1 << 18
TIER_RESUME_POLICY = {"inner_steps": 8, "final_steps": 16}
TIER_ROW_BYTES = 300 * 4 + 4
# the step's own device temporaries beside the hot window and the staged
# segment, per hot row: Newton-CG's Hessian subsample (its rows of X and
# y); its batched Armijo search, which evaluates all its candidate steps
# in one GEMM and holds up to TIER_LS_ARRAYS (rows, candidates) float32
# arrays at once (margins, losses); TIER_VECTORS float32 vectors
# (curvatures, the CG terms); B1's scratch and the eval probe within
# TIER_SLACK
TIER_LS_ARRAYS = 4
TIER_VECTORS = 16
TIER_SLACK = 64 * 2**20


def tiered_spec(api, n: int, hbm_bytes, policy: dict, *, obs: bool = False):
    """w8a_like at ``n`` rows in a memory store of 16,384-row shards,
    squared hinge, Newton-CG (the Hessian on max(0.1, 600 / n) of the
    rows), ``fixed_steps`` from n0 = min(2^16, n / 4) by growth 2, tiered
    under ``hbm_bytes`` (None: the untiered plane)."""
    tiering = api.TieringSpec() if hbm_bytes is None else \
        api.TieringSpec(enabled=True, hbm_bytes=int(hbm_bytes))
    return api.RunSpec(
        data=api.DataSpec(dataset="w8a_like", scale=n / 8192,
                          plane="plane", store="memory",
                          shard_size=TIER_SHARD, tiering=tiering),
        policy=api.PolicySpec("fixed_steps", policy),
        optimizer=api.OptimizerSpec(
            "newton_cg", {"hessian_fraction": min(1.0, max(0.1, 600 / n))}),
        schedule=api.ScheduleSpec(n0=min(TIER_N0, n // 4)),
        obs=api.ObsSpec(enabled=obs))


@contextlib.contextmanager
def commit_syncs(torch, corpus):
    """Count the synchronizes (device, stream or event) the driver makes
    inside the corpus's commits; the stager thread's own waits are not
    counted."""
    local = threading.local()
    count = {"syncs": 0, "commits": 0}
    commit = corpus._commit_staged

    def counted():
        local.on = True
        count["commits"] += 1
        try:
            return commit()
        finally:
            local.on = False

    def counting(fn):
        def wrapped(*a, **k):
            if getattr(local, "on", False):
                count["syncs"] += 1
            return fn(*a, **k)
        return wrapped

    saved = [(owner, name, getattr(owner, name)) for owner, name in (
        (torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize"),
        (torch.cuda.Event, "synchronize"))]
    for owner, name, fn in saved:
        setattr(owner, name, counting(fn))
    corpus._commit_staged = counted
    try:
        yield count
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        del corpus._commit_staged


def scale_claims(sess, tr, n: int, bit_compatible: bool) -> dict:
    """BENCH_scale.json's twelve claims (benchmarks/bench_scale.py's
    definitions, kept here) over a tiered session's meters and its event
    stream's RunReport."""
    ds = sess.dataset
    snap, tier = ds.meter.snapshot(), ds.tier_meter.snapshot()
    report = sess.run_report()
    ev, ev_tiers = report.claims(), report.tier_summary()
    return {
        "corpus_ge_4x_budget": n >= 4 * ds.hot_cap,
        "trains_end_to_end": len(tr.points) > 0
        and int(tr.points[-1].window) == n,
        "overlap_ge_half": snap["overlap_fraction"] >= 0.5,
        "staging_overlap_ge_half": tier["staging_overlap"] >= 0.5,
        "zero_resident_reupload": tier["resident_reuploads"] == 0,
        "each_example_loaded_once": snap["examples_loaded"] == n,
        "no_ring_evictions_unbounded": tier["evictions"] == 0,
        "trajectory_bit_compatible_with_untiered": bit_compatible,
        "events_overlap_ge_half": ev["overlap_ge_half"],
        "events_zero_resident_reupload": ev["zero_resident_reupload"]
        and ev_tiers is not None and ev_tiers["resident_reuploads"] == 0,
        "events_each_example_loaded_once": ev["each_example_loaded_once"],
        "events_match_meter": report.matches_meter(snap),
    }


def fresh_card(torch) -> int:
    """Free what the last run left and return the bytes still allocated,
    with the peak counter reset to them."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def tiered_phase(torch, rt, n: int = TIER_N, resume_n: int = TIER_RESUME_N,
                 policy: dict = TIER_POLICY, short: dict = TIER_SHORT,
                 resume_policy: dict = TIER_RESUME_POLICY) -> dict:
    """3p: ``n`` rows under an HBM budget of a quarter of the corpus,
    through ``api.build(spec, device="cuda")`` with the launch counts
    zeroed just before the run and read just after; then a full-budget run
    of the same corpus against the untiered plane (bitwise) and a
    kill-and-resume of a rotating run at ``resume_n`` rows (bitwise).
    Returns the tiered run's row; every check fails the run at its end."""
    api, ops, methods = rt["api"], rt["ops"], rt["methods"]
    t_phase = time.perf_counter()
    corpus_bytes = n * TIER_ROW_BYTES
    hbm = corpus_bytes // TIER_RATIO
    base = fresh_card(torch)
    t0 = time.perf_counter()
    sess = api.build(tiered_spec(api, n, hbm, policy, obs=True),
                     device="cuda")
    build_s = time.perf_counter() - t0
    ds = sess.dataset
    torch.cuda.synchronize()
    ops.reset_calls()
    with commit_syncs(torch, ds) as syncs:
        t0 = time.perf_counter()
        tr = sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.CALLS)
    implied = methods.kernel_calls(tr)
    peak = torch.cuda.max_memory_allocated() - base
    hot_cap = ds.hot_cap
    seg_bytes = hot_cap * TIER_ROW_BYTES
    hessian = sess.optimizer.hessian_fraction
    work = int(math.ceil(hessian * hot_cap)) * TIER_ROW_BYTES + 4 * hot_cap \
        * (TIER_LS_ARRAYS * sess.optimizer.max_ls_steps + TIER_VECTORS) \
        + TIER_SLACK
    tier = ds.tier_meter.snapshot()
    snap = ds.meter.snapshot()
    stages = tr.column("stage")

    # the same corpus with the whole of it in the budget, against the
    # untiered plane: bitwise f̂ on the window, the columns and the final w
    pair = {}
    for name, hb in (("full_budget", corpus_bytes), ("untiered", None)):
        fresh_card(torch)
        t0 = time.perf_counter()
        s2 = api.build(tiered_spec(api, n, hb, short), device="cuda")
        t2 = s2.run()
        torch.cuda.synchronize()
        pair[name] = {"trace": t2, "wall_s": time.perf_counter() - t0,
                      "mode": getattr(s2.dataset, "mode", "plane"),
                      "params": checksum(torch, rt, t2.params)}
        del s2
    cols = ("step", "stage", "window", "time", "accesses", "f_window")
    differ = [c for c in cols if pair["full_budget"]["trace"].column(c)
              != pair["untiered"]["trace"].column(c)]
    if pair["full_budget"]["params"] != pair["untiered"]["params"]:
        differ.append("params")
    claims = scale_claims(sess, tr, n, bit_compatible=not differ)
    row = {
        "path": "tiered", "n": n, "d": 300, "row_bytes": TIER_ROW_BYTES,
        "corpus_bytes": corpus_bytes, "hbm_bytes": hbm, "hot_cap": hot_cap,
        "shard_size": TIER_SHARD, "policy": policy, "build_s": build_s,
        "wall_s": wall, "stages": len(set(stages)),
        "steps_per_stage": [stages.count(k) for k in sorted(set(stages))],
        "tier_report": ds.tier_report(), "meter": snap,
        "launches": launches.get("linear_value_grad", 0),
        "implied_launches": implied,
        "max_memory_allocated": peak,
        "hbm_plus_segment": hbm + seg_bytes,
        "workspace": peak - 2 * seg_bytes, "workspace_bound": work,
        "commit_syncs": syncs, "host_transfers": tr.meta["host_transfers"],
        "f_window_final": tr.final().f_window,
        "f_full_final": tr.final().f_full, "claims": claims,
        "full_budget": {k: {"wall_s": v["wall_s"], "mode": v["mode"],
                            "steps": len(v["trace"].points)}
                        for k, v in pair.items()},
        "full_budget_differs_from_untiered": differ}
    del sess, tr, pair
    emit(row)
    if not all(claims.values()):
        fail_later(f"tiered: claims {[k for k, v in claims.items() if not v]}"
                   f" do not hold")
    if row["launches"] != implied:
        fail_later(f"tiered: B1 launched {row['launches']} times, the trace "
                   f"implies {implied}")
    if syncs["syncs"] or not syncs["commits"]:
        fail_later(f"tiered: {syncs['syncs']} synchronizes in "
                   f"{syncs['commits']} commits")
    if not peak <= hbm + seg_bytes + work:
        fail_later(f"tiered: peak {peak} bytes above the budget "
                   f"{hbm} + a segment {seg_bytes} + workspace {work}")
    if tier["resident_reuploads"] or snap["examples_loaded"] != n:
        fail_later(f"tiered: {tier['resident_reuploads']} re-uploads, "
                   f"{snap['examples_loaded']} of {n} examples loaded")
    if differ:
        fail_later(f"tiered: the full-budget run differs from the untiered "
                   f"plane in {differ}")

    # kill-and-resume of a rotating run, bitwise the uninterrupted one
    fresh_card(torch)
    spec = tiered_spec(api, resume_n, resume_n * TIER_ROW_BYTES // TIER_RATIO,
                       resume_policy)
    resumed = kill_and_resume(torch, rt, spec, 1, CONVEX_COLUMNS,
                              tiered=True)
    emit(dict(resumed, path="tiered_resume", n=resume_n))
    emit({"phase": "tiered", "seconds": time.perf_counter() - t_phase})
    # the arrays the phase made stay in the session's memo otherwise
    rt["api"].session._convex_arrays.cache_clear()
    rt["api"].session._convex_problem.cache_clear()
    fresh_card(torch)
    return row


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


# main()'s phases, in the order they run; ``--phases`` picks some (with
# what each needs before it), for a short card call on one part
PHASES = ("kernels", "convex", "registry", "while", "legacy", "obs",
          "convex_plane", "convex_methods", "lm", "hybrid", "resume", "dist",
          "mesh", "transformer", "sweep", "serving", "tiered", "card_vs_cpu")
PHASE_NEEDS = {"while": ("convex",)}


def selected_phases(argv=None) -> set:
    """The phases ``--phases a,b`` names (all of them with no argument),
    with those they need."""
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port's main paths "
                                 "on one card and check them.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all): "
                         + ", ".join(PHASES))
    args = ap.parse_args(argv)
    if args.phases is None:
        return set(PHASES)
    chosen = {p.strip() for p in args.phases.split(",") if p.strip()}
    unknown = chosen - set(PHASES)
    if unknown or not chosen:
        ap.error(f"unknown phases {sorted(unknown)}; known: {PHASES}")
    for p in list(chosen):
        chosen.update(PHASE_NEEDS.get(p, ()))
    return chosen


def main(argv=None) -> None:
    selected = selected_phases(argv)

    def run(phase: str) -> bool:
        return phase in selected

    # the full-width runs hold most of the card: segments that grow in
    # place keep the allocator's split blocks from stranding memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch import api, configs, workloads
    from repro_torch.data import synthetic
    from repro_torch.data.device_window import window_rows
    from repro_torch.kernels import build, linear_grad, ops, ref
    from repro_torch import serve as serve_pkg
    from repro_torch.launch import methods
    from repro_torch.launch import serve
    from repro_torch.launch import dryrun, forensics, mesh, shardings, steps
    from repro_torch.models import shard_ctx
    from repro_torch.models import linear
    from repro_torch.models import transformer
    from repro_torch.optim import adam
    from repro_torch.optim.api import tree_leaves, tree_map
    build_dir = root / "build"
    build_dir.mkdir(exist_ok=True)
    rt = dict(api=api, synthetic=synthetic, linear_grad=linear_grad,
              ops=ops, ref=ref, linear=linear, transformer=transformer,
              adam=adam, tree_map=tree_map, tree_leaves=tree_leaves,
              methods=methods, window_rows=window_rows, build_dir=build_dir,
              configs=configs, workloads=workloads,
              resolve_family=workloads.resolve_family, serve=serve,
              serve_pkg=serve_pkg, dryrun=dryrun, forensics=forensics,
              mesh=mesh, shardings=shardings, steps=steps,
              shard_ctx=shard_ctx)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(smi, flush=True)
    rt["smi"] = smi
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
    if run("kernels"):
        main_row = kernel_phase(torch, rt)
        scan_rows = scan_kernel_phase(torch, rt)
        scan_row = scan_rows["falcon-mamba-7b"]
        rglru_rows = rglru_kernel_phase(torch, rt)
        rglru_row = rglru_rows["recurrentgemma-9b"]
        attn_row = attention_kernel_phase(torch, rt)
    # 3. the main paths, each with its own launch counts
    if run("convex"):
        launches = main_path_phase(torch, rt)
    if run("registry"):
        registry_phase(torch, rt)
    if run("while"):
        while_row = while_graph_phase(torch, rt)
    if run("legacy"):
        legacy_phase(torch, rt)
    if run("obs"):
        obs_phase(torch, rt)
    if run("convex_plane"):
        plane_launches = convex_plane_phase(torch, rt)
    if run("convex_methods"):
        method_launches = convex_methods_phase(torch, rt)
    if run("lm"):
        lm_plane_vs_host_phase(torch, rt, "falcon-mamba-7b")
        lm = lm_main_path_phase(torch, rt)
    if run("hybrid"):
        lm_plane_vs_host_phase(torch, rt, "recurrentgemma-9b")
        hybrid = hybrid_main_path_phase(torch, rt)
    if run("resume"):
        resume_phase(torch, rt)
    # the multi-host runtime and elastic recovery
    if run("dist"):
        dist_launches = dist_convex_phase(torch, rt)
        elastic_convex_phase(torch, rt)
        dist_mamba = dist_lm_phase(torch, rt, "falcon-mamba-7b")
        dist_hybrid = dist_lm_phase(torch, rt, "recurrentgemma-9b")
        process_phase(torch, rt)
    # the launch tooling: the dry run, and a train step under a mesh
    if run("mesh"):
        t0 = time.perf_counter()
        mesh_dry_run_phase(torch, rt)
        mesh_step_phase(torch, rt)
        emit({"path": "launch_tooling", "phase_s": time.perf_counter() - t0,
              "card": smi})
    # the transformer and moe families, the zoo and the workload presets
    if run("transformer"):
        tf_launches = {}
        for arch, policy in TF_RUNS:
            tf_run = transformer_main_path_phase(torch, rt, arch, policy)
            for k, v in tf_run["launches"].items():
                tf_launches[k] = tf_launches.get(k, 0) + v
        zoo_phase(torch, rt)
    if run("sweep"):
        presets = sweep_phase(torch, rt)
        serve_preset = {k: v for r in presets if r["scenario"] == "serve"
                        for k, v in r["kernel_calls"].items()}
    # serving: prefill and decode at full width, the closed loop, the A/B
    if run("serving"):
        serving = serving_phase(torch, rt)
        serve_loop = serve_loop_phase(torch, rt)
        serve_ab_phase(torch, rt)
    # the tiered corpus: a corpus four times its HBM budget
    if run("tiered"):
        tiered = tiered_phase(torch, rt)
    # 4. card against CPU
    if run("card_vs_cpu"):
        card_vs_cpu_phase(torch, rt)
        for arch in ("falcon-mamba-7b", "recurrentgemma-9b") + tuple(
                a for a, _ in TF_RUNS):
            lm_card_vs_cpu_phase(torch, rt, arch)
        serve_card_vs_cpu_phase(torch, rt)
    if FAILED:
        raise SystemExit(f"chip_smoke: {len(FAILED)} checks failed: "
                         f"{FAILED}")
    if selected != set(PHASES):
        # a selection: the kernels' line needs every phase's counts
        emit({"phases": [p for p in PHASES if p in selected]})
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    hybrid_prefill = serving["hybrid"][
        f"launches_pallas_{serving['hybrid']['prompt']}"]

    emit({"kernels": [{
        "name": "linear_value_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_grad.cu",
        "replaces": "src/repro/kernels/linear_grad.py:50",
        "launches": launches,
        "launches_convex_plane": plane_launches,
        "launches_convex_methods": method_launches,
        "launches_dist": dist_launches,
        "launches_transformer_moe": tf_launches.get("linear_value_grad", 0),
        "launches_serve_loop": serve_loop["launches"].get(
            "linear_value_grad", 0),
        "launches_tiered": tiered["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "call_ms": main_row["kernel_call_ms"],
        "shape": list(MAIN_SHAPE), "check": main_row["check"]}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:45",
        "launches": lm["launches"]["ssm_scan"],
        "launches_dist": dist_mamba["launches"]["ssm_scan"],
        "launches_transformer_moe": tf_launches.get("ssm_scan", 0),
        "launches_serve_loop": serve_loop["launches"].get("ssm_scan", 0),
        "launches_serve_loop_implied":
            (serve_loop["launches_implied"] or {}).get("ssm_scan"),
        "launches_hybrid_prefill": hybrid_prefill.get("ssm_scan", 0),
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
        "launches_dist": dist_hybrid["launches"]["rglru_scan"],
        "launches_transformer_moe": tf_launches.get("rglru_scan", 0),
        "launches_hybrid_prefill": hybrid_prefill.get("rglru_scan", 0),
        "launches_serve_preset": serve_preset.get("rglru_scan", 0),
        "max_abs_err": rglru_row["max_abs_err"],
        "ms": rglru_row["kernel_ms"], "plain_ms": rglru_row["plain_ms"],
        "bound_ms": rglru_row["bound_ms"],
        "bound_by": rglru_row["bound_by"], "library_ms": None,
        "call_ms": rglru_row["kernel_call_ms"],
        "probe_ms": rglru_rows["probe"]["kernel_ms"],
        "probe_bound_ms": rglru_rows["probe"]["bound_ms"],
        "shape": [rglru_row["B"], rglru_row["S"], rglru_row["W"]],
        "dtype": rglru_row["dtype"], "check": rglru_row["check"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": hybrid["launches"]["flash_attention"],
        "launches_dist": dist_hybrid["launches"]["flash_attention"],
        "launches_transformer_moe": tf_launches.get("flash_attention", 0),
        "launches_hybrid_prefill": hybrid_prefill.get("flash_attention", 0),
        "launches_serve_preset": serve_preset.get("flash_attention", 0),
        "max_abs_err": attn_row["max_abs_err"],
        "ms": attn_row["kernel_ms"], "plain_ms": attn_row["plain_ms"],
        "bound_ms": attn_row["bound_ms"], "bound_by": attn_row["bound_by"],
        "library_ms": attn_row["library_ms"],
        "call_ms": attn_row["kernel_call_ms"],
        "probe_ms": attn_row["probe_ms"],
        "probe_bound_ms": attn_row["probe_bound_ms"],
        "shape": [attn_row[k] for k in ("B", "S", "H", "KV", "hd")],
        "window": attn_row["window"], "dtype": attn_row["dtype"],
        "check": attn_row["check"]}, {
        "name": "device_while", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/device_while.cu",
        "replaces": "src/repro/core/engine.py:444",
        "launches": rt["main_two_track"]["device_while"],
        "launches_lm": lm["launches"].get("device_while", 0),
        "launches_transformer_moe": tf_launches.get("device_while", 0),
        "launches_dist": rt["dist_while"],
        "max_abs_err": while_row["max_abs_err"],
        "ms": while_row["ms"], "plain_ms": while_row["plain_ms"],
        "bound_ms": while_row["bound_ms"],
        "bound_by": while_row["bound_by"], "library_ms": None,
        "capture_ms": while_row["capture_ms"],
        "stage": while_row["stage"], "steps": while_row["steps"],
        "check": "the race of quickstart@6's longest racing stage against "
                 "the plain loop on the card, histories and carries"}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
