"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's configuration, traffic mix,
driven path, limits and per-layer readers are found by name from files
(``loader.py``).  The run makes its inputs from ``--seed`` on the card,
warms every shape the cell uses (set-up), measures for ``--seconds``
seconds, then checks what the timed path produced against the plain
reference under ``perfbench/reference/``.  With ``--trace 1`` it also
profiles a bounded span of the window and reports the per-layer metrics
instead of the end-to-end ones.  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, end standard
error and the result line.  Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits with 3.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (Linux's
    /proc), or now where that cannot be read."""
    now_pc, now = time.perf_counter(), time.time()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        started = btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return now_pc
    return now_pc - max(0.0, now - started)


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"                # transformers loads no JAX
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# modules that may never be loaded: the JAX package, JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names, compared whole, among the modules
    ``names`` (by default every module loaded)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def measure(cell, *, seed: int, seconds: float, trace: bool, device,
            t0: float) -> dict:
    """Drive the cell's path and reduce what it returns to the result
    line's fields (no printing, no card check: the tests drive it on the
    CPU)."""
    import torch

    from perfbench import loader
    from perfbench.yardstick import devtrace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = types.SimpleNamespace(
        torch=torch, device=torch.device(device), config=cell.config,
        traffic=cell.traffic, limits=cell.limits, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), t0=t0,
        log=lambda *a: print(*a, file=sys.stderr, flush=True))
    res = cell.path().run(ctx)
    checks = res["checks"]
    correct = bool(checks) and not res["failed"] and all(
        c["value"] <= c["limit"] for c in checks)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = loader.reader(m["name"]).read(res["records"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(res["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else
           ctx.device.type,
           "kind": torch.cuda.get_device_name(0)
           if ctx.device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    span = res["records"].get("span")
    if trace and span is not None:
        lo, hi = span.start_ns, span.end_ns
        dev["busy_s"] = devtrace.merged_busy_ns(span.device, lo, hi) * 1e-9
        dev["window_s"] = (hi - lo) * 1e-9
        out["breakdown"] = devtrace.breakdown(span)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import loader
    cell = loader.cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s), found {have}; nothing measured", file=sys.stderr)
        return 3
    out = measure(cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device="cuda", t0=T0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 4
    limit = power_limit()
    if limit:
        out["device"]["name_power_limit"] = limit
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
