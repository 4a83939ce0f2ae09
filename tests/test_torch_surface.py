"""The port's public surface, name by name against the reference's.

Every public name of every module of ``repro`` (for a package
``__init__``, the names it exports; for a module, what it defines at
top level) resolves in the same module of ``repro_torch``, or stands in
``RENAMED`` or ``XLA_ONLY`` below with a counterpart that resolves.  The
README's port section carries the same table.  Then the extension hooks
(``register_policy``, ``register_optimizer``, ``register_store``) and
the names this surface added, each against the reference."""
import ast
import dataclasses
import importlib
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro.core as JC
import repro.optim as JO
import repro.workloads as JW
import repro_torch.api as P
import repro_torch.core as TC
import repro_torch.optim as TO
import repro_torch.workloads as TW
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.tier1

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# a reference name -> the port's name for the same thing
RENAMED = {
    "repro.dist.AxisCollectives": "repro_torch.dist.ProcessCollectives",
    "repro.dist.collectives.AxisCollectives":
        "repro_torch.dist.collectives.ProcessCollectives",
    "repro.dist.distributed_objective": "repro_torch.dist.DistributedObjective",
    "repro.dist.collectives.distributed_objective":
        "repro_torch.dist.collectives.DistributedObjective",
    "repro.launch.dryrun.ICI_BW": "repro_torch.launch.dryrun.NVLINK_BW",
}
# a reference name that exists for XLA, jit or Pallas alone -> what does
# its work in the port
XLA_ONLY = {
    "repro.dist.force_host_device_flag": "repro_torch.launch.mesh.fake_world",
    "repro.dist.topology.force_host_device_flag":
        "repro_torch.launch.mesh.fake_world",
    "repro.core.engine.cached_step": "repro_torch.optim.api.BatchOptimizer",
    "repro.core.engine.cached_eval":
        "repro_torch.models.linear.LinearObjective",
    "repro.core.engine.cached_variance":
        "repro_torch.core.engine.variance_stats",
    "repro.kernels.ops.INTERPRET": "repro_torch.kernels.ref",
    "repro.launch.hlo.Computation": "repro_torch.launch.hlo.analyze",
    "repro.launch.hlo.Module": "repro_torch.launch.hlo.analyze",
    "repro.launch.hlo.raw_cost_analysis": "repro_torch.launch.hlo.analyze",
    "repro.launch.shardings.shardings_tree":
        "repro_torch.launch.shardings.distribute_tree",
    "repro.launch.shardings.to_named":
        "repro_torch.launch.shardings.to_placements",
    "repro.launch.specs.SDS": "repro_torch.launch.specs.batch_specs",
    "repro.obs.profile.cost_from_compiled": "repro_torch.obs.profile.cost",
    "repro.obs.profile.hlo_cost": "repro_torch.launch.hlo.analyze",
}


def _resolve(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj
    raise ImportError(dotted)


def _public_names(path: pathlib.Path) -> list:
    """A package ``__init__``'s exports (its ``__all__``, else what it
    imports, defines and assigns); a module's top-level definitions and
    assignments."""
    tree = ast.parse(path.read_text())
    init = path.name == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if t.id == "__all__" and init:
                        return sorted(ast.literal_eval(node.value))
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif init and isinstance(node, ast.ImportFrom) and \
                node.module != "__future__":
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


def _module(path: pathlib.Path) -> str:
    parts = path.relative_to(SRC).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


REF_FILES = sorted((SRC / "repro").rglob("*.py"))
INITS = [p for p in REF_FILES if p.name == "__init__.py"]


def _check_module(path):
    mod = _module(path)
    port = importlib.import_module("repro_torch" + mod[len("repro"):])
    missing = []
    for name in _public_names(path):
        key = f"{mod}.{name}"
        table = RENAMED.get(key) or XLA_ONLY.get(key)
        if table is not None:
            assert not hasattr(port, name), \
                f"{key} is in the port now: take it out of the table"
            _resolve(table)
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{mod}: {missing}"


@pytest.mark.parametrize("path", INITS, ids=_module)
def test_every_package_export_resolves_in_the_port(path):
    _check_module(path)


@pytest.mark.parametrize("path", [p for p in REF_FILES
                                  if p.name != "__init__.py"], ids=_module)
def test_every_module_name_resolves_in_the_port(path):
    _check_module(path)


def test_the_tables_name_only_reference_names():
    for key in {**RENAMED, **XLA_ONLY}:
        mod, name = key.rsplit(".", 1)
        path = SRC / (mod.replace(".", "/") + ".py")
        if not path.exists():
            path = SRC / mod.replace(".", "/") / "__init__.py"
        assert name in _public_names(path), key


# -------------------------------------------------------- extension hooks
def _hooked(monkeypatch, api, registry_name: str, name: str, factory):
    """Register ``factory`` under ``name`` through ``api``'s hook; the
    registry is a module global, so the entry goes when the test ends."""
    reg = getattr(api, registry_name)
    monkeypatch.setitem(reg._entries, name, None)
    hook = {"POLICIES": api.register_policy,
            "OPTIMIZERS": api.register_optimizer,
            "STORES": api.register_store}[registry_name]
    assert hook(name, factory) is factory
    assert name in reg and reg.get(name) is factory


def _spec(api, policy: str, optimizer: str):
    """w8a_like at 1,024 × 300 from a first window of 128, Newton-CG."""
    return api.RunSpec(
        data=api.DataSpec(dataset="w8a_like", scale=0.125, lam=1e-3),
        policy=api.PolicySpec(policy, {"inner_steps": 4, "final_steps": 8}),
        optimizer=api.OptimizerSpec(optimizer, {"hessian_fraction": 0.2}),
        schedule=api.ScheduleSpec(n0=128, clock={"p": 10.0, "a": 1.0,
                                                 "s": 5.0}))


COLUMNS = ("step", "stage", "window", "time", "accesses")


def test_registered_policy_and_optimizer_run_as_the_built_ins(monkeypatch):
    for api, core, optim in ((R, JC, JO), (P, TC, TO)):
        _hooked(monkeypatch, api, "POLICIES", "my_fixed", core.FixedSteps)
        _hooked(monkeypatch, api, "OPTIMIZERS", "my_newton", optim.NewtonCG)
    ref = R.build(_spec(R, "my_fixed", "my_newton")).run()
    port = P.build(_spec(P, "my_fixed", "my_newton"), device="cpu").run()
    builtin = P.build(_spec(P, "fixed_steps", "newton_cg"),
                      device="cpu").run()
    assert len(port.points) == len(ref.points) == len(builtin.points)
    for col in COLUMNS:
        assert port.column(col) == ref.column(col) == builtin.column(col)
    np.testing.assert_allclose(port.column("f_full"), ref.column("f_full"),
                               rtol=1e-4, atol=1e-3)
    assert port.column("f_full") == builtin.column("f_full")
    assert torch.equal(port.params, builtin.params)


def test_an_unconstructible_registered_store_is_refused(monkeypatch):
    arr = np.zeros((8, 3), np.float32)
    for api in (R, P):
        _hooked(monkeypatch, api, "STORES", "my_store", object)
        with pytest.raises(api.SpecError, match="registered but not "
                           "constructible from a DataSpec"):
            api.make_store("my_store", arr, 4)
        with pytest.raises(api.SpecError, match="unknown store 'nope'"):
            api.make_store("nope", arr, 4)
    assert type(P.make_store("memory", arr, 4)).__name__ == \
        type(R.make_store("memory", arr, 4)).__name__


@pytest.mark.parametrize("api,optim", [(R, JO), (P, TO)],
                         ids=["reference", "port"])
def test_an_unregistered_optimizer_names_the_hook(api, optim):
    @dataclasses.dataclass(frozen=True)
    class Mine(optim.GradientDescent):
        name: str = "mine"

    with pytest.raises(api.SpecError, match=r"register_optimizer\(\)"):
        api.optimizer_spec_of(Mine())


@pytest.mark.parametrize("registry", ["POLICIES", "OPTIMIZERS", "STORES",
                                      "TIERS", "TOPOLOGIES"])
def test_registries_hold_the_references_names(registry):
    ref, port = getattr(R, registry), getattr(P, registry)
    assert sorted(k for k, _ in port.items()) == port.names() == ref.names()
    assert not hasattr(port, "pending")


# ----------------------------------------------------- the names added
def test_tree_math_on_trees_and_tensors():
    rng = np.random.default_rng(0)
    a = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    b = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    ja, jb = jax.tree_util.tree_map(jax.numpy.asarray, (a, b))
    ta = {"w": torch.from_numpy(a["w"]), "b": [torch.from_numpy(a["b"][0])]}
    tb = {"w": torch.from_numpy(b["w"]), "b": [torch.from_numpy(b["b"][0])]}
    for fn in ("tree_add", "tree_sub"):
        got = getattr(TO, fn)(ta, tb)
        want = getattr(JO, fn)(ja, jb)
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"][0].numpy(),
                                      np.asarray(want["b"][0]))
    np.testing.assert_allclose(float(TO.tree_norm(ta)),
                               float(JO.tree_norm(ja)), rtol=1e-6)
    np.testing.assert_allclose(float(TO.tree_norm(ta["w"])),
                               float(JO.tree_norm(ja["w"])), rtol=1e-6)
    assert torch.equal(TO.tree_add(ta["w"], tb["w"]), ta["w"] + tb["w"])


def test_make_optimizer_builds_the_references_optimizers():
    for name in sorted(JO.REGISTRY):
        j = JO.make_optimizer(name)
        t = TO.make_optimizer(name)
        assert type(t).__name__ == type(j).__name__
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TO.make_optimizer("newton_cg", hessian_fraction=0.5) \
        .hessian_fraction == 0.5
    from repro_torch.optim.gd import GDState
    assert issubclass(GDState, dict)


def test_opt_state_specs_are_the_references():
    for arch in ("qwen3_0p6b", "falcon_mamba_7b"):
        jcfg = jconfigs.reduced(jconfigs.get(arch))
        tcfg = tconfigs.reduced(tconfigs.get(arch))
        want = jsteps.opt_state_specs(JT.param_specs(jcfg))
        got = tsteps.opt_state_specs(TT.param_specs(tcfg))
        assert got["t"].device.type == "meta"
        assert tuple(got["t"].shape) == tuple(want["t"].shape)
        wl = jax.tree_util.tree_leaves_with_path(want["m"])
        for path, leaf in wl:
            node = got["m"]
            for p in path:
                node = node[p.key]
            assert tuple(node.shape) == tuple(leaf.shape), path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
            assert node.device.type == "meta"


def test_model_families_meet_the_protocol():
    assert all(isinstance(f, TW.ModelFamily) for f in TW.FAMILIES.values())
    assert all(isinstance(f, JW.ModelFamily) for f in JW.FAMILIES.values())
    assert not isinstance(object(), TW.ModelFamily)


def test_package_exports_are_the_modules_objects():
    import repro_torch.data as TD
    import repro_torch.data.tiers as TT_
    import repro_torch.models as TM
    from repro_torch.models import common
    assert TM.ModelConfig is common.ModelConfig
    for sub in ("linear", "transformer", "attention", "moe", "mamba",
                "rglru", "layers"):
        assert getattr(TM, sub).__name__ == f"repro_torch.models.{sub}"
    for name in ("HostRing", "RingTierManager", "TieredCorpus", "TierMeter"):
        assert getattr(TD, name) is getattr(TT_, name)
    with pytest.raises(AttributeError):
        TD.NoSuchName
    assert P.LMStepOptimizer.__module__ == "repro_torch.api.lm"
    assert callable(P.make_lm_objective) and P.TokenWindows
