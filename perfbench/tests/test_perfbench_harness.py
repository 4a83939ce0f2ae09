"""The benchmark harness on the CPU: cells found by name from files, the
import rule, the frozen counts against hand-worked values, and the
refusal to measure without a card."""
from __future__ import annotations

import ast
import json
import types
from pathlib import Path

import pytest
import torch

from perfbench import loader, run
from perfbench.paths import convex_solve
from perfbench.yardstick import bounds, devtrace

HERE = Path(loader.__file__).resolve().parent
BENCH = loader.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("cell", CELLS)
def test_perfbench_cell_found_by_name(cell):
    c = loader.cell(cell)
    assert c.config["name"] == {w["name"]: w for w in BENCH["workloads"]
                                }[cell]["config"]
    assert (HERE / "paths" / f"{c.traffic['path']}.py").exists()
    assert hasattr(c.path(), "run")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_perfbench_metric_reader_found_by_name(metric):
    mod = loader.reader(metric)
    assert mod.read({}) is None, "a reader with nothing to read reports "\
        "nothing"
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}


def test_perfbench_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert set(c["reduced"]) <= set(json.loads(
            (HERE.parent / c["file"]).read_text())["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"model step", "kernels", "device"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(HERE)) for p in HERE.rglob("*.py")))
def test_perfbench_imports_no_jax_nor_the_jax_package(path):
    names = _imports(HERE / path)
    assert not names & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, \
        names
    if path.startswith("reference"):
        assert "repro_torch" not in names, "the reference is the program's"


def test_perfbench_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.api",
                                  "repro_torchlike", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core", "jaxlib.xla_client",
                                  "torch"]) == ["jaxlib", "repro"]


def test_perfbench_bounds_against_hand_worked_values():
    # B1 at 49,152 x 300: 4(nd + n + 2d + 1) bytes, 4nd flops
    b = bounds.bounds_ms(49152, 300)
    assert b["bytes_bound_ms"] == pytest.approx(59181412 / 3.35e12 * 1e3)
    assert b["flops_bound_ms"] == pytest.approx(58982400 / 67e12 * 1e3)
    assert b["bound_by"] == "bytes"
    # one Newton-CG step at n = 1000, d = 300: 4nd + 2kd + 10·4kd + 30·2nd
    assert bounds.newton_cg_step_flops(
        1000, 300, hessian_fraction=0.2, cg_steps=10,
        ls_candidates=30) == 21_720_000


def test_perfbench_devtrace_reductions():
    dev = [("k1", 0, 10), ("k2", 5, 10), ("k1", 30, 5)]
    host = [("outer", 0, 100), ("inner", 16, 29)]
    assert devtrace.merged_busy_ns(dev, 0, 40) == 20
    assert devtrace.time_by_name(dev) == {"k1": 15, "k2": 10}
    gaps = devtrace.idle_gaps(dev, host, 0, 40)
    assert gaps[0] == ["inner", pytest.approx(15e-9)]
    assert gaps[1] == ["outer", pytest.approx(5e-9)]


def test_perfbench_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    assert run.main(["--workload", CELLS[0], "--seed", "3", "--seconds",
                     "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "nothing measured" in out.err


def _trace(*points):
    return types.SimpleNamespace(points=[
        types.SimpleNamespace(stage=st, window=n, extra=dict(extra))
        for st, n, extra in points])


def test_perfbench_convex_plan_counts_each_stage_from_its_trace():
    trace = _trace((0, 1000, {}), (0, 1000, {}), (1, 4000, {}))
    stages = convex_solve._stages(trace)
    assert stages == [(1000, 2), (4000, 1)]
    launches, flops = convex_solve.plan(stages, 300,
                                        {"hessian_fraction": 0.2})
    assert launches == [1000, 1000, 4000]
    # 21,720,000 a step at n = 1000 (above); 4 × that at n = 4000
    assert flops == 2 * 21_720_000 + 4 * 21_720_000


def test_perfbench_convex_plan_refuses_a_racing_stage():
    with pytest.raises(ValueError, match="racing"):
        convex_solve._stages(_trace((0, 1000, {"f_fast_on_t": 1.0})))


def _solves_span():
    """Two traced solves: B1 launches of 2 and 1 ns, 4 and 2 ns."""
    span = devtrace.Span(torch)
    span.start_ns, span.end_ns = 0, 100
    span.host = [("perfbench.solve", 0, 40), ("perfbench.solve", 50, 90)]
    span.device = [("lvg_kernel", 5, 2), ("lvg_kernel", 20, 1),
                   ("gemv", 25, 15), ("lvg_kernel", 55, 4),
                   ("lvg_kernel", 70, 2)]
    return span


def test_perfbench_linear_grad_roofline_over_whole_solves():
    reader = loader.reader("linear_grad_roofline")
    rec = {"span": _solves_span(), "d": 300,
           "b1_launches": [[49152, 4096], [49152, 4096]]}
    want = 2 * sum(bounds.bounds_ms(n, 300)["bound_ms"]
                   for n in (49152, 4096)) * 1e6 / (2 + 1 + 4 + 2)
    assert reader.read(rec) == pytest.approx(100 * want)
    # a solve whose launches the trace does not hold whole is left out
    rec["b1_launches"] = [[49152, 4096], [49152]]
    want = sum(bounds.bounds_ms(n, 300)["bound_ms"]
               for n in (49152, 4096)) * 1e6 / (2 + 1)
    assert reader.read(rec) == pytest.approx(100 * want)


def test_perfbench_device_idle_convex_merges_the_span():
    rec = {"span": _solves_span()}
    # busy: [5, 7], [20, 21], [25, 40], [55, 59], [70, 72] = 24 of 100 ns
    assert loader.reader("device.idle.convex").read(rec) == \
        pytest.approx(76.0)


def test_perfbench_mfu_convex_against_hand_worked_values():
    rec = {"model_flops": 6.7e12, "window_s": 2.0, "peak_flops": "float32"}
    assert loader.reader("mfu.convex").read(rec) == pytest.approx(5.0)
