#!/usr/bin/env python3
"""One checkout's B1 and B4 kernels on the card, for comparing two
checkouts on one card: their outputs bit for bit, their times, the
hybrid path's f̂, and the LM train steps' peak memory phase by phase.

    python3 src/repro_torch/launch/kernel_compare.py run TREE OUT \
        [--hybrid] [--step-memory]
    python3 src/repro_torch/launch/kernel_compare.py diff OUT_A OUT_B

``run`` imports ``repro_torch`` from TREE/src (TREE is a checkout's root,
so one process measures one checkout; its kernels are built into
TREE/build/kernels) and ``chip_smoke`` from the checkout that holds this
script, whose seeded inputs and timing it uses: rglru_scan (B4) at the
hybrid path's train-step shape (bfloat16 and float32) and its probe's
shape, linear_value_grad (B1) at the convex path's w8a_like@6 window
(both losses).  It saves each output under OUT (``torch.save``) and
prints one JSON line with each kernel's card time (``chip_smoke.time_ms``:
back to back behind a spin kernel).  With ``--hybrid`` it then runs
chip_smoke.py's recurrentgemma-9b ``fixed_steps`` path at full width and
prints f̂ on the probe before the run and after each stage.  With
``--step-memory`` it then takes one train step of each of chip_smoke.py's
full-width LM paths (falcon-mamba-7b and recurrentgemma-9b at its layers
and batch) as the checkout's own ``loss_fn`` defaults make it (its
rematerialization included), in three phases: the forward with the
graph, the backward, and the AdamW update; each after
``torch.cuda.reset_peak_memory_stats`` and ended by a synchronize, a
first step a warm-up.  It prints one line per path with each phase's
host-clock seconds and peak allocated GB, and the loss and the squared
gradient norm as float hex (equal across checkouts when the step's
arithmetic is).

``diff`` prints, for each output saved in both directories, how many
elements differ and the largest difference; in bfloat16, how many differ
by one unit in the last place, how many by more (and the largest such
value), and how many in sign.  To compare a parent with a
change, run parent, change, change, parent in one call on one card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def step_memory(torch, cs, api, arch: str, layers: int, batch_size: int,
                seq: int, corpus: int) -> dict:
    """One full-width train step of an LM path, phase by phase (see the
    module's docstring)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.adam import adamw_init, adamw_update
    from repro_torch.optim.api import tree_leaves, tree_map

    spec = cs.lm_spec(api, arch=arch, reduced=False, policy="fixed_steps",
                      corpus=corpus, seq_len=seq, n0=batch_size,
                      layers=layers, batch=batch_size)
    sess = api.build(spec, device="cuda")
    cfg, params = sess.model_config, sess.w0
    rows = sess.dataset.window(batch_size)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    opt_state = adamw_init(params)
    row = {"path": arch, "layers": layers, "batch": [batch_size, seq]}

    def phase(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        row[f"{name}_s"] = time.perf_counter() - t0
        row[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return result

    for _ in range(2):                      # the first is a warm-up
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = phase("forward", lambda: T.loss_fn(
                cfg, p, batch, impl="pallas")[0])
            grads = phase("backward", lambda: torch.autograd.grad(
                loss, tree_leaves(p)))
        del p
        it = iter(grads)
        tree = tree_map(lambda _: next(it), params)
        phase("adamw", lambda: adamw_update(params, tree, opt_state,
                                            lr=3e-4, weight_decay=0.1))
        row["loss"] = float(loss.detach()).hex()
        row["grad_sq"] = float(sum(torch.sum(g.float() ** 2)
                                   for g in grads)).hex()
        del loss, grads, tree
    return row


def run(tree: Path, out: Path, hybrid: bool, memory: bool) -> None:
    sys.path.insert(0, str(tree.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    # the hybrid run holds most of the card, as in chip_smoke.py
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: no CUDA device")
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.data import synthetic
    from repro_torch.kernels import linear_grad, ops, rglru_scan

    out.mkdir(parents=True, exist_ok=True)
    spin = cs.spin_cycles_per_s(torch)
    row = {"tree": str(tree), "rglru_scan": rglru_scan.__file__}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, B, dname in (("path", cs.HY_BATCH, "bfloat16"),
                            ("path", cs.HY_BATCH, "float32"),
                            ("probe", cs.HY_EVAL_ROWS, "bfloat16")):
        a, b = cs.rglru_inputs(torch, gen, B, cs.HY_SEQ, cs.HY_WIDTH,
                               getattr(torch, dname))
        y = ops.rglru_scan(a, b)
        torch.save(y.cpu(), out / f"rglru_{label}_{dname}.pt")
        row[f"rglru_{label}_{dname}_ms"] = cs.time_ms(
            torch, lambda: ops.rglru_scan(a, b), spin)["ms"]
        del a, b, y
    ds = synthetic.load("w8a_like", scale=6.0, device="cuda")
    w = 0.1 * torch.randn((ds.X.shape[1],), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(0))
    for loss in cs.LOSSES:
        L, g = linear_grad.linear_value_grad(ds.X, ds.y, w, loss=loss)
        torch.save(torch.cat([g, L[None]]).cpu(), out / f"lvg_{loss}.pt")
        row[f"lvg_{loss}_ms"] = cs.time_ms(
            torch, lambda: linear_grad.linear_value_grad(ds.X, ds.y, w,
                                                          loss=loss),
            spin)["ms"]
    del ds, w, L, g
    gc.collect()
    torch.cuda.empty_cache()
    if hybrid:
        spec = cs.lm_spec(api, arch="recurrentgemma-9b", reduced=False,
                          policy="fixed_steps", corpus=cs.HY_CORPUS,
                          seq_len=cs.HY_SEQ, n0=cs.HY_N0,
                          layers=cs.HY_LAYERS, batch=cs.HY_BATCH,
                          eval_rows=cs.HY_EVAL_ROWS,
                          fixed=(cs.HY_INNER, cs.HY_FINAL))
        sess = api.build(spec, device="cuda")
        row["f_full_w0"] = float(sess.objective(sess.w0, sess.eval_data))
        ops.reset_calls()
        t0 = time.perf_counter()
        tr = sess.run()
        torch.cuda.synchronize()
        row["hybrid_wall_s"] = time.perf_counter() - t0
        row["launches"] = dict(ops.CALLS)
        row["f_full_after_stage"] = [
            [p for p in tr.points if p.stage == end["stage"]][-1].f_full
            for end in sess.stage_ends]
        del sess, tr
    print(json.dumps(row), flush=True)
    if memory:
        for path in (("falcon-mamba-7b", cs.LM_LAYERS, cs.LM_BATCH,
                      cs.LM_SEQ, cs.LM_CORPUS),
                     ("recurrentgemma-9b", cs.HY_LAYERS, cs.HY_BATCH,
                      cs.HY_SEQ, cs.HY_CORPUS)):
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps({"tree": str(tree),
                              **step_memory(torch, cs, api, *path)}),
                  flush=True)


def diff(dir_a: Path, dir_b: Path) -> None:
    import torch
    for path in sorted(dir_a.glob("*.pt")):
        other = dir_b / path.name
        if not other.exists():
            continue
        x, y = torch.load(path), torch.load(other)
        differ = x != y
        row = {"output": path.stem, "elements": x.numel(),
               "differ": int(differ.sum()),
               "max_abs_diff": float((x.double() - y.double()).abs().max())}
        if x.dtype == torch.bfloat16:
            ulps = (x.view(torch.int16).int() - y.view(torch.int16).int())
            same_sign = (x.view(torch.int16) < 0) == (y.view(torch.int16) < 0)
            far = same_sign & (ulps.abs() > 1)
            row["one_ulp"] = int((same_sign & (ulps.abs() == 1)).sum())
            # more than one ulp apart: values near 0, where a float32 carry
            # that differs in its last bits spans many bfloat16 ulps
            row["over_one_ulp"] = int(far.sum())
            row["over_one_ulp_max_abs_value"] = \
                float(x[far].double().abs().max()) if bool(far.any()) else None
            row["sign_differs"] = int((~same_sign & differ).sum())
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("tree", type=Path)
    r.add_argument("out", type=Path)
    r.add_argument("--hybrid", action="store_true")
    r.add_argument("--step-memory", action="store_true")
    d = sub.add_parser("diff")
    d.add_argument("a", type=Path)
    d.add_argument("b", type=Path)
    args = ap.parse_args()
    if args.cmd == "run":
        run(args.tree, args.out, args.hybrid, args.step_memory)
    else:
        diff(args.a, args.b)


if __name__ == "__main__":
    main()
