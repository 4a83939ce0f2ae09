"""The port's front door: reference specs load and run, unported branches
and a missing card fail with clear errors, and ``convert.params_from_jax``
carries a reference mid-run state across."""
import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro.data import synthetic as jsyn
from repro.models import linear as jlin
from repro.optim import GradientDescent as JGD, NewtonCG as JNCG
from repro_torch import convert
from repro_torch.models import linear as tlin
from repro_torch.optim import GradientDescent as TGD, NewtonCG as TNCG

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

BASE = dict(data=R.DataSpec(dataset="w8a_like", scale=0.03, lam=1e-3),
            schedule=R.ScheduleSpec(n0=32))


def test_reference_spec_json_builds_and_runs():
    spec = R.RunSpec(name="gd_batch", policy=R.PolicySpec("batch", {"steps": 5}),
                     optimizer=R.OptimizerSpec("gd", {"max_ls_steps": 20}),
                     meta={"origin": "reference"}, **BASE)
    text = spec.to_json()
    port_spec = P.RunSpec.from_json(text)
    assert port_spec.to_json() == text            # identical schema
    sess = P.build(port_spec, device="cpu")
    tr = sess.run()
    ref = R.build(spec).run()
    assert tr.method == ref.method == "gd_batch"
    assert tr.meta["origin"] == "reference"
    assert tr.column("time") == ref.column("time")
    np.testing.assert_allclose(tr.column("f_full"), ref.column("f_full"),
                               rtol=1e-5)


def test_build_accepts_a_dict_and_memoizes_the_problem():
    d = R.RunSpec(policy=R.PolicySpec("fixed_steps"), **BASE).to_dict()
    a = P.build(d, device="cpu")
    b = P.build(dict(d, data=dict(d["data"], store="memmap")), device="cpu")
    assert a.dataset is b.dataset and a.objective is b.objective


LM = dict(data=R.DataSpec(kind="lm"),
          optimizer=R.OptimizerSpec("adamw_lm", {"batch_size": 4}))


@pytest.mark.parametrize("change,needle", [
    # once refused as the moe slice's; the moe family now builds it
    (dict(LM, model=R.ModelSpec(arch="granite-moe-1b-a400m", reduced=True)),
     None),
    # the plane, checkpoints, multiple hosts, the elastic runtime and
    # serving are ported: what stays refused is the tiered corpus and
    # observability (the fleet recorder of a multi-host run too); a serve
    # spec, also of an elastic multi-host run or an LM on the plane, is
    # refused by build as the reference refuses it, pointing at build_loop
    (dict(data=R.DataSpec(plane="plane", tiering=R.TieringSpec(
        enabled=True, hbm_bytes=1))), "tiered-corpus slice"),
    (dict(data=R.DataSpec(plane="plane"), topology=R.TopologySpec(hosts=2),
          obs=R.ObsSpec(enabled=True, fleet=True)), "observability slice"),
    (dict(data=R.DataSpec(tiering=R.TieringSpec(enabled=True, hbm_bytes=1))),
     "tiered-corpus slice"),
    (dict(data=R.DataSpec(plane="plane"), topology=R.TopologySpec(hosts=4),
          elastic=R.ElasticSpec(enabled=True),
          serve=R.ServeSpec(enabled=True)), "build_loop"),
    (dict(checkpoint=R.CheckpointSpec(directory="ck"),
          topology=R.TopologySpec(hosts=2), data=R.DataSpec(
              plane="plane", tiering=R.TieringSpec(enabled=True,
                                                   hbm_bytes=1))),
     "tiered-corpus slice"),
    (dict(obs=R.ObsSpec(enabled=True)), "observability slice"),
    (dict(serve=R.ServeSpec(enabled=True)), "build_loop"),
    (dict(LM, data=R.DataSpec(kind="lm", plane="plane"),
          model=R.ModelSpec(arch="falcon-mamba-7b"),
          serve=R.ServeSpec(enabled=True)), "build_loop"),
    # traffic_driven is registered now; observed, it still waits
    (dict(policy=R.PolicySpec("traffic_driven"),
          obs=R.ObsSpec(enabled=True)), "observability slice"),
    # one torch.distributed process per host: refused before any process
    # group is asked for, convex and LM alike
    (dict(data=R.DataSpec(plane="plane"),
          topology=R.TopologySpec(kind="process", hosts=2)),
     "multi-process slice"),
    (dict(LM, model=R.ModelSpec(arch="falcon-mamba-7b"),
          topology=R.TopologySpec(kind="process", hosts=2)),
     "multi-process slice"),
], ids=["lm", "plane", "hosts", "tiering", "elastic", "checkpoint", "obs",
        "serve", "adamw_lm", "traffic_driven", "process", "process_lm"])
def test_unported_branches_raise_spec_error(change, needle):
    spec = P.RunSpec.from_json(R.RunSpec(**{**BASE, **change}).to_json())
    if needle is None:
        sess = P.build(spec, device="cpu")
        assert sess.model_config.family == "moe"
        sess.close()
        return
    if needle == "build_loop":
        # the reference's own refusal, in both packages, naming the front
        # door that builds a serve spec
        with pytest.raises(R.SpecError, match="repro.serve.build_loop"):
            R.build(R.RunSpec.from_json(spec.to_json()))
        with pytest.raises(P.SpecError,
                           match="repro_torch.serve.build_loop"):
            P.build(spec, device="cpu")
        return
    with pytest.raises(P.SpecError, match="not yet ported") as e:
        P.build(spec, device="cpu")
    assert needle in str(e.value)


@pytest.mark.parametrize("bad,needle", [
    (dict(optimizer=R.OptimizerSpec("newton_gc")), "did you mean"),
    (dict(policy=R.PolicySpec("two_track", {"nope": 1})), "two_track"),
    (dict(data=R.DataSpec(dataset="mnist")), "unknown convex dataset"),
    (dict(schedule=R.ScheduleSpec(step_cost="batch")), "batch_size"),
    (dict(data=R.DataSpec(tiering=R.TieringSpec(hbm_bytes=8))), "enabled=False"),
    (dict(optimizer=R.OptimizerSpec("adamw_lm")), "LM train step"),
], ids=["typo", "bad_param", "dataset", "step_cost", "budget", "adamw_lm"])
def test_reference_validation_kept(bad, needle):
    with pytest.raises(P.SpecError, match=needle):
        P.build(P.RunSpec(**{**BASE, **bad}), device="cpu")


def test_build_without_card_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = P.RunSpec(**BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.convex_problem(spec.data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax({"w": np.zeros(3, np.float32)})


@pytest.mark.parametrize("jopt,topt", [
    (JNCG(hessian_fraction=0.2), TNCG(hessian_fraction=0.2)),
    (JGD(), TGD()),
], ids=["newton_cg", "gd"])
def test_params_from_jax_carries_a_mid_run_state(jopt, topt):
    ds = jsyn.load("w8a_like", scale=0.05)
    data = (ds.X, ds.y)
    jobj = jlin.make_objective("squared_hinge", lam=1e-3)
    jstep = jax.jit(lambda p, s: jopt.step(p, s, jobj, data))
    w, st = jlin.init_params(ds.d), jopt.init(jlin.init_params(ds.d))
    for _ in range(3):
        w, st, _ = jstep(w, st)
    exported = jax.device_get({"w": w, "state": st})     # numpy leaves
    carried = convert.params_from_jax(exported, device="cpu")
    assert carried["w"].dtype == torch.float32
    assert carried["w"].shape == (ds.d,)
    for k, v in exported["state"].items():
        assert np.array_equal(np.asarray(carried["state"][k]), v)
    w_next, _, _ = jstep(w, st)
    tdata = (torch.from_numpy(np.array(ds.X)), torch.from_numpy(np.array(ds.y)))
    tw, _, _ = topt.step(carried["w"], carried["state"],
                         tlin.make_objective("squared_hinge", lam=1e-3), tdata)
    np.testing.assert_allclose(tw.numpy(), np.asarray(w_next), rtol=1e-3,
                               atol=1e-5)


def test_params_from_jax_keeps_nested_structure():
    tree = {"layers": [{"w": np.ones((2, 3), np.float32)},
                       {"b": np.int32(4)}],
            "pair": (np.zeros(2, np.float64), None), "lr": 0.1}
    out = convert.params_from_jax(tree, device="cpu")
    assert out["layers"][0]["w"].shape == (2, 3)
    assert out["layers"][1]["b"].dtype == torch.int32
    assert int(out["layers"][1]["b"]) == 4
    assert isinstance(out["pair"], tuple) and out["pair"][1] is None
    assert out["pair"][0].dtype == torch.float64 and out["lr"] == 0.1
    with pytest.raises(TypeError, match="numpy arrays"):
        convert.params_from_jax({"x": "text"}, device="cpu")
