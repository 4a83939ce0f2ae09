"""Find a cell's pieces by name, from files.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  The
configuration is ``perfbench/configs/<config>.json``, the mix is
``perfbench/traffic/<traffic>.json``, whose ``"path"`` names the driven
path ``perfbench/paths/<path>.py``, and the limits of the comparison that
decides ``correct`` are ``perfbench/checks/<cell>.json``.  A per-layer
metric is ``perfbench/metrics/<metric>.py``, a reader with
``read(records) -> float | None``.  Nothing here knows a cell: a cell, a
mix, a configuration or a metric is added by adding files.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list            # the entries of the metrics it reports
    per_layer: list

    def path(self):
        """The driven path's module, ``perfbench/paths/<path>.py``."""
        return path_module(self.traffic["path"])


def path_module(name: str):
    return importlib.import_module(f"perfbench.paths.{name}")


def reader(metric: str):
    """The reader of a per-layer metric, ``perfbench/metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   "perfbench_metric_" + metric.replace(".", "_")
                   .replace("-", "_"))


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(ROOT / conf["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "checks" / f"{name}.json"),
                end_to_end=e2e,
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name, e2e_names)])
