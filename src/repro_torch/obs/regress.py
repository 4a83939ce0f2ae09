"""Bench regression sentinel + the BENCH trajectory renderer;
the port's copy of ``repro.obs.regress`` (no JAX there either);
its anchors are the repo's committed ``BENCH_*.json``, which it only
reads.

The committed ``BENCH_*.json`` files are the repo's perf anchors — the
measured claims each PR must keep green.  Until now nothing compared a
*fresh* run against them (CI re-asserts each module's own claims at smoke
scale, but a silently weakened claim set or a regressed headline metric
would pass), and nothing recorded the trajectory across runs.  This
module closes both gaps:

  * :func:`compare` — one observed report vs its committed anchor.  Every
    claim the anchor holds true must still be true (a claim that
    *appears* in the anchor but is missing from the observed report is a
    regression, not a skip), and the module's **guarded metrics**
    (:data:`GUARDED`) must stay inside a tolerance band around the
    anchor value — direction-aware, so a *faster* engine or a *tighter*
    trajectory deviation never fails.  Failures render as readable
    observed-vs-anchor deltas.

  * ``python -m repro_torch.obs.regress --check <dir>`` — the sentinel CI runs
    on the ``--smoke`` output directory: each ``BENCH_*.json`` found is
    compared against the committed anchor of the same name.  Smoke runs
    are tiny, so CI passes ``--claims-only`` (scalar bands only make
    sense at anchor scale).

  * ``python -m repro_torch.obs.regress [--history PATH]`` — renders the
    ``BENCH_history.jsonl`` trajectory that ``benchmarks/run.py`` appends
    to after every benchmark run (see ``benchmarks/history.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

#: Benchmark modules with committed anchors at the repo root.
MODULES = ("engine", "data", "dist", "elastic", "serve", "workloads",
           "scale")

#: Guarded metrics per module: (dotted path, direction, rel_slack,
#: abs_slack).  ``ge`` — observed must stay above ``anchor*(1-rel)-abs``;
#: ``le`` — below ``anchor*(1+rel)+abs``.  Bands are deliberately loose
#: (wall-clock noise, container variance); the claims are the hard gate,
#: these catch a headline metric quietly falling off a cliff.
GUARDED: dict[str, list[tuple[str, str, float, float]]] = {
    "engine": [
        ("methods.bet_fixed.speedup", "ge", 0.5, 0.0),
        ("methods.two_track.speedup", "ge", 0.5, 0.0),
        ("methods.bet_fixed.engine.syncs_per_stage", "le", 0.0, 0.0),
    ],
    "data": [
        ("meter.overlap_fraction", "ge", 0.2, 0.0),
        ("meter.reuse_ratio", "ge", 0.5, 0.0),
    ],
    "dist": [
        ("trajectory_max_rel_dev", "le", 0.0, 1e-3),
        ("global_meter.overlap_fraction", "ge", 0.5, 0.0),
    ],
    "elastic": [
        ("straggler.trajectory_max_rel_dev", "le", 0.0, 1e-3),
        ("host_loss.survivor_reupload_bytes_all_stages", "le", 0.0, 0.0),
    ],
    "serve": [
        ("throughput_ratio", "ge", 0.15, 0.0),
        ("runs.swap.staleness.max_warm", "le", 0.0, 0.0),
    ],
    "workloads": [],
    "scale": [
        ("meter.overlap_fraction", "ge", 0.2, 0.0),
        ("tier.resident_reuploads", "le", 0.0, 0.0),
    ],
}

HISTORY_NAME = "BENCH_history.jsonl"


@dataclasses.dataclass
class Delta:
    """One observed-vs-anchor regression."""
    module: str
    what: str                   # claim name or metric path
    anchor: object
    observed: object
    detail: str

    def __str__(self) -> str:
        return (f"{self.module}/{self.what}: observed "
                f"{self.observed!r} vs anchor {self.anchor!r} "
                f"({self.detail})")


def get_path(d: dict, path: str):
    for part in path.split("."):
        if not isinstance(d, dict) or part not in d:
            return None
        d = d[part]
    return d


def guarded_metrics(module: str, report: dict) -> dict:
    """The module's guarded-metric values out of one report (for history
    records and the trajectory view)."""
    out = {}
    for path, _, _, _ in GUARDED.get(module, ()):
        v = get_path(report, path)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[path] = v
    return out


def compare(module: str, anchor: dict, observed: dict, *,
            claims_only: bool = False) -> list[Delta]:
    """Observed report vs committed anchor: claim set + tolerance bands."""
    deltas: list[Delta] = []
    for name, held in (anchor.get("claims") or {}).items():
        if not held:
            continue                    # an anchor-red claim gates nothing
        got = (observed.get("claims") or {}).get(name)
        if got is not True:
            state = "missing" if got is None else "failed"
            deltas.append(Delta(
                module, name, anchor=True, observed=got,
                detail=f"anchor-green claim {state} in observed report"))
    if claims_only:
        return deltas
    for path, direction, rel, abs_ in GUARDED.get(module, ()):
        a, o = get_path(anchor, path), get_path(observed, path)
        if not isinstance(a, (int, float)) or \
                not isinstance(o, (int, float)):
            continue                    # metric absent on either side
        if direction == "ge":
            bound = a * (1 - rel) - abs_
            if o < bound:
                deltas.append(Delta(
                    module, path, anchor=a, observed=o,
                    detail=f"below band: need >= {bound:.6g} "
                           f"(anchor*{1 - rel:g} - {abs_:g})"))
        else:
            bound = a * (1 + rel) + abs_
            if o > bound:
                deltas.append(Delta(
                    module, path, anchor=a, observed=o,
                    detail=f"above band: need <= {bound:.6g} "
                           f"(anchor*{1 + rel:g} + {abs_:g})"))
    return deltas


def check_dir(observed_dir, anchors_dir, *, claims_only: bool = False
              ) -> tuple[list[Delta], list[str]]:
    """Compare every ``BENCH_*.json`` in ``observed_dir`` against the
    anchor of the same name; returns ``(deltas, modules_checked)``."""
    observed_dir = pathlib.Path(observed_dir)
    anchors_dir = pathlib.Path(anchors_dir)
    deltas: list[Delta] = []
    checked: list[str] = []
    for module in MODULES:
        obs_path = observed_dir / f"BENCH_{module}.json"
        anc_path = anchors_dir / f"BENCH_{module}.json"
        if not obs_path.exists() or not anc_path.exists():
            continue
        with open(anc_path) as fh:
            anchor = json.load(fh)
        with open(obs_path) as fh:
            observed = json.load(fh)
        checked.append(module)
        deltas.extend(compare(module, anchor, observed,
                              claims_only=claims_only))
    return deltas, checked


# ------------------------------------------------------------------ history
def load_history(path) -> list[dict]:
    out = []
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


def render_history(records: list[dict]) -> str:
    """The BENCH trajectory, one line per run per module: claim pass
    counts and the guarded headline metrics over time."""
    if not records:
        return "no history recorded yet\n"
    by_module: dict[str, list[dict]] = {}
    for r in records:
        by_module.setdefault(r.get("module", "?"), []).append(r)
    lines = []
    for module in sorted(by_module):
        lines.append(f"{module}:")
        for r in by_module[module]:
            claims = r.get("claims") or {}
            npass = sum(1 for v in claims.values() if v)
            scale = "smoke" if r.get("smoke") else "full"
            metrics = " ".join(
                f"{p.split('.')[-1]}={v:.4g}"
                for p, v in (r.get("metrics") or {}).items())
            failed = sorted(k for k, v in claims.items() if not v)
            tail = f"  FAILED: {failed}" if failed else ""
            lines.append(f"  {r.get('ts_iso', '?'):>20} [{scale:5}] "
                         f"claims {npass}/{len(claims)} {metrics}{tail}")
    return "\n".join(lines) + "\n"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.obs.regress`` — trajectory view / CI sentinel."""
    import argparse

    ap = argparse.ArgumentParser(
        description="BENCH regression sentinel and trajectory renderer")
    ap.add_argument("--check", default=None, metavar="DIR",
                    help="compare DIR's BENCH_*.json against the "
                         "committed anchors; exit 1 on any delta")
    ap.add_argument("--anchors", default=None, metavar="DIR",
                    help="anchor directory (default: repo root)")
    ap.add_argument("--claims-only", action="store_true",
                    help="skip scalar tolerance bands (smoke-scale runs)")
    ap.add_argument("--history", default=None, metavar="PATH",
                    help=f"history log to render (default: "
                         f"{HISTORY_NAME} at the repo root)")
    args = ap.parse_args(argv)
    anchors = args.anchors or _repo_root()
    if args.check:
        deltas, checked = check_dir(args.check, anchors,
                                    claims_only=args.claims_only)
        if not checked:
            print(f"no BENCH_*.json reports under {args.check}")
            return 1
        for d in deltas:
            print(f"REGRESSION {d}")
        mode = "claims" if args.claims_only else "claims+bands"
        print(f"sentinel checked {checked} against {anchors} ({mode}): "
              f"{len(deltas)} regression(s)")
        return 1 if deltas else 0
    history = args.history or os.path.join(_repo_root(), HISTORY_NAME)
    print(render_history(load_history(history)), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
