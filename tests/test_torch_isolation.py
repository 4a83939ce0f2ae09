"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``repro``."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytestmark = pytest.mark.tier1

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


# the modules of the convex method set and the examples, which must be
# among those the import check walks (and importing an example or the
# method-set driver runs nothing)
CONVEX_MODULES = [
    "repro_torch.optim.nonlinear_cg", "repro_torch.optim.lbfgs",
    "repro_torch.optim.adagrad", "repro_torch.core.dsm",
    "repro_torch.core.theory", "repro_torch.launch.methods",
    "repro_torch.examples.quickstart", "repro_torch.examples.two_track_demo",
]
# the multi-host runtime and elastic recovery
DIST_MODULES = [
    "repro_torch.dist", "repro_torch.dist.ownership",
    "repro_torch.dist.topology", "repro_torch.dist.collectives",
    "repro_torch.dist.runtime", "repro_torch.elastic.faults",
    "repro_torch.elastic.runtime", "repro_torch.elastic.checkpoint",
]

# the transformer and moe families, the zoo and the workloads grammar
TRANSFORMER_MODULES = [
    "repro_torch.models.moe", "repro_torch.workloads",
    "repro_torch.workloads.presets", "repro_torch.launch.train",
] + [f"repro_torch.configs.{m}" for m in (
    "qwen3_0p6b", "internlm2_1p8b", "yi_9b", "stablelm_12b",
    "musicgen_medium", "qwen2_vl_2b", "granite_moe_1b_a400m",
    "llama4_scout_17b_a16e")]


# serving (prefill and decode, the closed loop) and the telemetry core
SERVE_MODULES = [
    "repro_torch.serve", "repro_torch.serve.ingest",
    "repro_torch.serve.policy", "repro_torch.serve.swap",
    "repro_torch.serve.loop", "repro_torch.launch.serve",
    "repro_torch.obs", "repro_torch.obs.events", "repro_torch.obs.metrics",
    "repro_torch.obs.report",
]

# the race's WHILE graph, observability and the workload sweep
OBS_MODULES = [
    "repro_torch.kernels.device_while", "repro_torch.obs.health",
    "repro_torch.obs.fleet", "repro_torch.obs.regress",
    "repro_torch.obs.profile", "repro_torch.workloads.sweep",
]

# the tiered corpus
TIER_MODULES = [
    "repro_torch.data.tiers", "repro_torch.data.tiers.manager",
    "repro_torch.data.tiers.host", "repro_torch.data.tiers.corpus",
    "repro_torch.data.tiers.ckpt",
]

# the launch tooling (mesh, shardings, specs, dry run, accounting,
# forensics, the shard hook) and the last two examples
LAUNCH_MODULES = [
    "repro_torch.launch.mesh", "repro_torch.launch.shardings",
    "repro_torch.launch.specs", "repro_torch.launch.hlo",
    "repro_torch.launch.dryrun", "repro_torch.launch.forensics",
    "repro_torch.models.shard_ctx", "repro_torch.examples.bet_lm_training",
    "repro_torch.examples.serve_decode",
]


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib, pkgutil, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(json.dumps(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout)
    assert len(names) >= 50
    assert set(CONVEX_MODULES) <= set(names)
    assert set(DIST_MODULES) <= set(names)
    assert set(TRANSFORMER_MODULES) <= set(names)
    assert set(SERVE_MODULES) <= set(names)
    assert set(OBS_MODULES) <= set(names)
    assert set(TIER_MODULES) <= set(names)
    assert set(LAUNCH_MODULES) <= set(names)
    assert out.stdout.count("\n") == 1         # no module printed a thing


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {mod}"
