"""The port's checkpoints against the reference's, on the CPU: the ``.npz``
+ ``.json`` format (bfloat16 bits, the keys of the same trees), rolling
and thinning, kill-and-resume within the port (bitwise), and stage
checkpoints that cross packages — convex both ways, the reduced mamba LM
from the reference into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.engine import ResumeState
from repro_torch.elastic import checkpoint as tstage
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_leaves

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# convex f̂ across packages (tests/test_torch_engine.py's bound) and the
# float32 reduced LM's (tests/test_torch_lm.py's)
RTOL_F = 1e-4
RTOL_F_LM = 2e-5
COLUMNS = ("step", "stage", "window", "time", "accesses")


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and lists, whatever their key order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix: tree}


def _npz(path):
    with np.load(str(path) + ".npz") as data:
        return {k: data[k] for k in data.files}


# -------------------------------------------------------------------- format
def test_bfloat16_round_trips_and_crosses_to_the_reference(tmp_path):
    cfg = tconfigs.reduced(tconfigs.get("falcon-mamba-7b"))
    assert cfg.dtype == torch.bfloat16
    params = TT.init_params(cfg, 0, device="cpu")
    opt = tsteps.init_opt_state(params)
    tckpt.save_checkpoint(tmp_path / "ck", params, opt, meta={"step": 7})
    p2, o2, meta = tckpt.load_checkpoint(tmp_path / "ck", params, opt)
    assert meta == {"step": 7}
    for a, b in zip(tree_leaves((params, opt)), tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference reads the same bits into its own bfloat16 tree
    jcfg = jconfigs.reduced(jconfigs.get("falcon-mamba-7b"))
    jparams = JT.init_params(jcfg, jax.random.key(0))
    back, _, _ = jckpt.load_checkpoint(tmp_path / "ck", jparams)
    got = _flat(convert.params_from_jax(jax.device_get(back), "cpu"))
    mine = _flat(params)
    assert sorted(got) == sorted(mine)
    assert any(a.dtype == torch.bfloat16 for a in mine.values())
    for k, a in mine.items():
        assert got[k].dtype == a.dtype and torch.equal(got[k], a), k


@pytest.mark.parametrize("tree", ["convex", "mamba"])
def test_save_state_keys_equal_the_reference(tmp_path, tree):
    """The same trees (the reference's, carried across by ``convert``)
    land under the same keys, with the same values and dtypes; the
    convex Newton-CG counter is a Python int in the port."""
    if tree == "convex":
        jtrees = {"params": jnp.arange(5, dtype=jnp.float32),
                  "opt": {"t": jnp.int32(3)}}
        ttrees = {"params": torch.arange(5, dtype=torch.float32),
                  "opt": {"t": 3}}
    else:
        jcfg = jconfigs.reduced(jconfigs.get("falcon-mamba-7b"))
        jp = JT.init_params(jcfg, jax.random.key(1))
        jtrees = {"params": jp,
                  "opt": {"opt": jsteps.init_opt_state(jp),
                          "t": jnp.int32(4)}}
        ttrees = convert.params_from_jax(jax.device_get(jtrees), "cpu")
    jckpt.save_state(tmp_path / "ref", jtrees, meta={"k": 1})
    tckpt.save_state(tmp_path / "port", ttrees, meta={"k": 1})
    ref, port = _npz(tmp_path / "ref"), _npz(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    if tree == "convex":
        assert "params/" in port and "opt/t" in port
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])
        if k != "opt/t" or tree != "convex":
            assert port[k].dtype == ref[k].dtype, k


def test_load_refuses_a_leaf_of_another_shape(tmp_path):
    tckpt.save_state(tmp_path / "s", {"params": torch.zeros(4)})
    with pytest.raises(ValueError, match="'params/' has shape"):
        tckpt.load_state(tmp_path / "s", {"params": torch.zeros(5)})


def test_checkpoint_manager_rolls_and_restores_the_latest(tmp_path):
    params = {"w": torch.arange(4.0), "b": [torch.ones(2), torch.zeros(())]}
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, params, stage=s, window=64 * s)
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.npz")) == \
        ["ckpt_00000003.npz", "ckpt_00000004.npz"]
    p2, opt, meta = mgr.restore(params)
    assert opt is None and meta["step"] == 4 and meta["window"] == 256
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert torch.equal(a, b)
    # and the reference's manager reads the port's directory
    _, _, jmeta = jckpt.CheckpointManager(str(tmp_path)).restore(
        {"w": jnp.zeros(4), "b": [jnp.zeros(2), jnp.zeros(())]})
    assert jmeta == meta


# ---------------------------------------------------------- stage checkpoints
def _convex_spec(policy, params, *, plane="plane", ckpt=None, **schedule):
    sched = dict(n0=32, clock={"p": 10.0, "a": 1.0, "s": 5.0})
    sched.update(schedule)
    return R.RunSpec(
        data=R.DataSpec(dataset="w8a_like", scale=0.05, lam=1e-3,
                        plane=plane, shard_size=32),
        policy=R.PolicySpec(policy, params),
        optimizer=R.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=R.ScheduleSpec(**sched),
        checkpoint=R.CheckpointSpec(directory=ckpt))


POLICIES = {"fixed_steps": {"inner_steps": 3, "final_steps": 5},
            "two_track": {"final_steps": 5, "max_stage_iters": 12}}


class _Killed(Exception):
    pass


def _killed_run(api, spec, kill_stage, **kw):
    """Run ``spec`` (which checkpoints) through ``api`` until the stage
    boundary ``kill_stage`` has been checkpointed, then die."""
    sess = api.build(spec, **kw)

    def die(end):
        if end.info.stage == kill_stage:
            raise _Killed

    sess.on_stage(die)
    with pytest.raises(_Killed):
        sess.run()
    return sess


def _stitch(resumed, trace, col):
    return [p[col] for p in resumed.restored.trace_points()] + \
        trace.column(col)


def _port(spec):
    return P.RunSpec.from_json(spec.to_json())


def test_stage_checkpointer_thins_by_keep_and_every(tmp_path):
    spec = _port(_convex_spec("fixed_steps", POLICIES["fixed_steps"],
                              ckpt=str(tmp_path)))
    spec = spec.replace(checkpoint=spec.checkpoint.replace(keep=2, every=2))
    sess = P.build(spec, device="cpu")
    sess.run()
    assert [i.stage for i in sess.stage_plan()] == [0, 1, 2, 3, 4]
    assert sess.checkpointer.saved == [0, 2, 4]     # the final always saves
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "stage_0002.json", "stage_0002.npz", "stage_0004.json",
        "stage_0004.npz"]
    for bad in ({"keep": 0}, {"every": 0}):
        with pytest.raises(ValueError, match="must be >= 1"):
            tstage.StageCheckpointer(str(tmp_path), **bad)


@pytest.mark.parametrize("plane,policy", [("plane", "fixed_steps"),
                                          ("plane", "two_track"),
                                          ("host", "two_track")])
def test_convex_kill_and_resume_is_bitwise(tmp_path, plane, policy):
    """Killed after stage 1 and resumed from its checkpoint in a fresh
    session, the stitched run equals the uninterrupted one bit for bit:
    every column, the final parameters and the engine's counters; the
    plane's restart reads are the rewarm record, its counters continue."""
    base = _port(_convex_spec(policy, POLICIES[policy], plane=plane))
    whole_sess = P.build(base, device="cpu")
    whole = whole_sess.run()
    spec = base.replace(checkpoint=P.CheckpointSpec(directory=str(tmp_path)))
    _killed_run(P, spec, 1, device="cpu")
    resumed = P.resume_session(tmp_path, device="cpu")
    tr = resumed.run()
    assert tr.meta["resumed_from_stage"] == 1
    assert resumed.restored.resume == ResumeState(
        next_stage=2, **{k: resumed.restored.meta["cursor"][c] for k, c in (
            ("step_count", "step"), ("stages", "stages"),
            ("transfers", "transfers"), ("overshoot", "overshoot"))})
    for col in COLUMNS + ("f_window", "f_full"):
        assert _stitch(resumed, tr, col) == whole.column(col), col
    assert torch.equal(tr.params, whole.params)
    for key in ("host_transfers", "race_overshoot", "stages"):
        assert tr.meta[key] == whole.meta[key], key
    if plane == "plane":
        assert tr.meta["resume_rewarm"]["examples_loaded"] == \
            resumed.restored.n_t == 64
        for k, v in whole.meta["data_plane"].items():
            if not isinstance(v, float):
                assert tr.meta["data_plane"][k] == v, k
    else:
        assert tr.meta["resume_rewarm"] == {}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_convex_stage_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by one package resumes in the other; the
    stitched run matches the reference's uninterrupted run (columns
    equal, f̂ within RTOL_F)."""
    spec = _convex_spec("two_track", POLICIES["two_track"],
                        ckpt=str(tmp_path))
    whole = R.build(spec.replace(checkpoint=R.CheckpointSpec())).run()
    if writer == "reference":
        _killed_run(R, spec, 1)
        resumed = P.resume_session(tmp_path, device="cpu")
    else:
        _killed_run(P, _port(spec), 1, device="cpu")
        resumed = R.resume_session(tmp_path)
    tr = resumed.run()
    assert tr.meta["resumed_from_stage"] == 1
    for col in COLUMNS:
        assert _stitch(resumed, tr, col) == whole.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(_stitch(resumed, tr, col),
                                   whole.column(col), rtol=RTOL_F)
    assert tr.meta["resume_rewarm"]["examples_loaded"] == 64
    assert tr.meta["data_plane"]["examples_loaded"] == \
        whole.meta["data_plane"]["examples_loaded"]


def test_mamba_stage_checkpoint_from_the_reference_resumes_in_the_port(
        tmp_path):
    """The reduced falcon-mamba-7b (float32) on the plane, two-track: the
    reference writes the checkpoint after stage 1, the port resumes it and
    finishes within RTOL_F_LM of the reference's uninterrupted run."""
    spec = R.RunSpec(
        data=R.DataSpec(kind="lm", corpus_size=32, seq_len=16, eval_rows=8,
                        plane="plane", shard_size=8),
        model=R.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=R.OptimizerSpec("adamw_lm", {"lr": 1e-3, "batch_size": 4}),
        policy=R.PolicySpec("two_track", {"final_steps": 2,
                                          "max_stage_iters": 4,
                                          "condition": "eval"}),
        schedule=R.ScheduleSpec(n0=8, step_cost="batch", wait_on_expand=True,
                                carry_state=True, clock={"preloaded": 8}),
        checkpoint=R.CheckpointSpec(directory=str(tmp_path)))
    whole = R.build(spec.replace(checkpoint=R.CheckpointSpec())).run()
    _killed_run(R, spec, 1)
    resumed = P.resume_session(tmp_path, device="cpu")
    tr = resumed.run()
    assert tr.meta["resumed_from_stage"] == 1
    assert len(tr.points) > 0
    for col in COLUMNS:
        assert _stitch(resumed, tr, col) == whole.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(_stitch(resumed, tr, col),
                                   whole.column(col), rtol=RTOL_F_LM)


def test_resume_refuses_a_spec_that_differs_from_the_checkpoint(tmp_path):
    spec = _port(_convex_spec("fixed_steps", POLICIES["fixed_steps"],
                              ckpt=str(tmp_path)))
    _killed_run(P, spec, 1, device="cpu")
    stored = tstage.peek_stage_meta(tmp_path / "stage_0001")["spec"]
    P.check_resume_spec(spec, stored)           # the same spec passes
    other = spec.replace(schedule=spec.schedule.replace(n0=64),
                         checkpoint=spec.checkpoint.replace(resume=True))
    with pytest.raises(P.SpecError, match=r"mismatch on \['schedule'\]"):
        P.check_resume_spec(other, stored)
    with pytest.raises(P.SpecError, match="mismatch"):
        P.build(other, device="cpu").run()
    with pytest.raises(P.SpecError, match="needs a checkpoint directory"):
        P.build(spec.replace(checkpoint=P.CheckpointSpec(resume=True)),
                device="cpu")
    with pytest.raises(FileNotFoundError):
        P.resume_session(tmp_path / "none", device="cpu")


@pytest.mark.parametrize("kind,needle", [
    # ported: restoring it into another kind of dataset is refused
    ("distributed", "constructed a 'plain' one"),
    ("tiered", "queue A11")])
def test_restore_names_the_slice_of_an_unported_dataset_kind(kind, needle):
    with pytest.raises(ValueError, match=needle):
        tstage.restore_dataset(object(), {"kind": kind}, 64)
