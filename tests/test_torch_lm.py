"""The port's LM path (the mamba family) against the reference, on the
CPU: the model's loss on the reduced falcon-mamba-7b with the reference's
parameters carried across (float32, and bfloat16 through the ``ml_dtypes``
path), one train step, ``build(RunSpec lm)`` under ``fixed_steps``, the
data helpers, the registry and the validation; then, within the port,
that the chunked Two-Track race returns what a race in chunks of one step
returns on LM carries, and how many scan launches an LM run implies."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro import configs as jconfigs
from repro.data import device_window as jdw
from repro.data import window as jwindow
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.data import device_window as tdw
from repro_torch.data import window as twindow
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_leaves
from repro_torch.workloads import families as tfam

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# f̂ of the float32 reduced model after a few AdamW steps, the same
# algorithm summed in other orders: measured within 1.1e-6 relative;
# 2e-5 leaves an order of magnitude
RTOL_F = 2e-5


def _cfgs(dtype_j, dtype_t):
    jcfg = jconfigs.reduced(jconfigs.get("falcon-mamba-7b")).with_(
        dtype=dtype_j)
    tcfg = tconfigs.reduced(tconfigs.get("falcon-mamba-7b")).with_(
        dtype=dtype_t)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def f32_model():
    jcfg, tcfg = _cfgs(jnp.float32, torch.float32)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, params


def _batch(cfg, B=2, S=32, seed=0):
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok[:, :-1]),
             "labels": jnp.asarray(tok[:, 1:])},
            {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])})


def test_loss_fn_matches_reference(f32_model):
    """The whole reduced model (2 ssm layers, the scan through the kernel
    route), float32, against the reference at 1e-5 relative."""
    jcfg, tcfg, params = f32_model
    jb, tb = _batch(jcfg)
    want, _ = JT.loss_fn(jcfg, params, jb, impl="pallas")
    got, metrics = TT.loss_fn(tcfg, convert.params_from_jax(params, "cpu"),
                              tb, impl="pallas")
    assert got.dtype == torch.float32 and float(metrics["ce_loss"]) == \
        float(got)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_bfloat16_parameters_carry_across():
    """The reference's default bfloat16 tree exports as ml_dtypes arrays;
    they arrive as torch.bfloat16 with every value kept.  The bfloat16
    losses agree within 5e-3 relative: the two frameworks round the
    activations to bfloat16 at different places (measured 3.5e-5 to
    5.5e-4 over four seeds; bfloat16 keeps 2^-8 = 3.9e-3)."""
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(1)))
    assert params["embed"].dtype.name == "bfloat16"
    carried = convert.params_from_jax(params, device="cpu")
    assert carried["embed"].dtype == torch.bfloat16
    assert carried["stack_ssm"]["A_log"].dtype == torch.float32
    np.testing.assert_array_equal(
        carried["stack_ssm"]["in_proj_u"].float().numpy(),
        np.asarray(params["stack_ssm"]["in_proj_u"], np.float32))
    jb, tb = _batch(jcfg, seed=1)
    want, _ = JT.loss_fn(jcfg, params, jb, impl="pallas")
    got, _ = TT.loss_fn(tcfg, carried, tb, impl="pallas")
    np.testing.assert_allclose(float(got), float(want), rtol=5e-3)


def _items(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_train_step_matches_reference(f32_model):
    """One AdamW step (lr 1e-3, weight decay 0.1): the loss at 1e-5, the
    first moments (0.1·gradient) within 1e-6 absolute (gradients agree to
    ~4e-6 at most, against entries up to 0.4).  The first step moves a
    weight by lr·g/(|g| + eps) ≈ ±lr, so parameters agree within 1e-5
    wherever |g| > 1e-5; where the gradient is that close to 0 its sign
    may differ between the frameworks, and the step by up to 2·lr."""
    jcfg, tcfg, params = f32_model
    jb, tb = _batch(jcfg, seed=2)
    jstep = jsteps.make_train_step(jcfg, lr=1e-3, impl="pallas")
    jp, jst, jm = jax.device_get(
        jstep(params, jsteps.init_opt_state(params), jb))
    tp0 = convert.params_from_jax(params, "cpu")
    tstep = tsteps.make_train_step(tcfg, lr=1e-3, impl="pallas")
    tp, tst, tm = tstep(tp0, tsteps.init_opt_state(tp0), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert int(tst["t"]) == int(jst["t"]) == 1
    for (name, got_p), (_, got_m), (_, want_p), (_, want_m) in zip(
            _items(tp), _items(tst["m"]), _items(jp), _items(jst["m"])):
        np.testing.assert_allclose(got_m.numpy(), want_m, atol=1e-6,
                                   err_msg=name)
        clear = np.abs(want_m) > 1e-6              # |g| > 1e-5
        diff = np.abs(got_p.numpy() - want_p)
        assert diff[clear].max(initial=0.0) <= 1e-5
        assert diff.max() <= 2e-3 + 1e-5
    # functional: the step wrote nothing into its inputs
    for k, v in params["stack_ssm"].items():
        np.testing.assert_array_equal(tp0["stack_ssm"][k].numpy(), v)


def _lm_spec(policy, params, *, corpus=32, n0=16):
    return R.RunSpec(
        data=R.DataSpec(kind="lm", corpus_size=corpus, seq_len=16,
                        eval_rows=8),
        model=R.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=R.OptimizerSpec("adamw_lm", {"lr": 1e-3, "batch_size": 4}),
        policy=R.PolicySpec(policy, params),
        schedule=R.ScheduleSpec(n0=n0, step_cost="batch",
                                wait_on_expand=True, carry_state=True,
                                clock={"preloaded": n0}))


def test_lm_build_fixed_steps_matches_reference():
    """build(RunSpec lm) through both packages, the reference's parameters
    carried into the port's session: equal schedule, clock and access
    columns, f̂ within RTOL_F."""
    spec = _lm_spec("fixed_steps", {"inner_steps": 3, "final_steps": 3})
    ref_sess = R.build(spec)
    ref = ref_sess.run()
    sess = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
    sess.w0 = convert.params_from_jax(jax.device_get(ref_sess.w0), "cpu")
    port = sess.run()
    assert len(port.points) == len(ref.points) == 6
    for col in ("step", "stage", "window", "time", "accesses"):
        assert port.column(col) == ref.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(port.column(col), ref.column(col),
                                   rtol=RTOL_F)
    assert port.meta["arch"] == ref.meta["arch"] == "falcon-mamba-7b"
    assert port.meta["host_transfers"] == ref.meta["host_transfers"]


def _race_calls(monkeypatch):
    calls = []
    real = tops.ssm_scan

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tops, "ssm_scan", counting)
    return calls


def test_lm_chunked_race_equals_a_race_of_single_steps(monkeypatch):
    """Two-Track on LM carries (dicts of parameters and AdamW moments):
    the chunked race returns bitwise what a race in chunks of one step
    (``RACE_DOUBLING`` off) returns, and the scan runs
    num_layers times per forward pass the traces and the overshoot imply
    (per race step: two train steps and three f̂ probes; per final step:
    one train step and one f̂ probe) — the count chip_smoke.py holds the
    card's launches to."""
    spec = P.RunSpec.from_json(_lm_spec(
        "two_track", {"final_steps": 2, "max_stage_iters": 8,
                      "condition": "eval", "final_eval_full": True},
        n0=8).to_json())
    calls = _race_calls(monkeypatch)
    runs = []
    for single in (False, True):
        if single:
            monkeypatch.setattr(tengine, "RACE_DOUBLING", False)
        sess = P.build(spec, device="cpu")
        ends, record = [], sess.engine.stage_callback
        sess.engine.stage_callback = lambda e, record=record, ends=ends: (
            ends.append((e.params, e.opt_state)), record(e))
        del calls[:]
        tr = sess.run()
        runs.append((tr, ends, len(calls)))
    (chunked, c_ends, c_calls), (single, s_ends, s_calls) = runs
    for col in ("step", "stage", "window", "time", "accesses", "f_window",
                "f_full"):
        assert chunked.column(col) == single.column(col), col
    for (cw, cs), (sw, ss) in zip(c_ends, s_ends):
        for a, b in zip(tree_leaves((cw, cs)), tree_leaves((sw, ss))):
            assert torch.equal(a, b)
    assert single.meta["race_overshoot"] == 0
    layers = sess.model_config.num_layers
    for tr, n in ((chunked, c_calls), (single, s_calls)):
        race = sum("f_fast_on_t" in p.extra for p in tr.points) \
            + tr.meta["race_overshoot"]
        final = sum("f_fast_on_t" not in p.extra for p in tr.points)
        assert n == layers * (5 * race + 2 * final)


def test_lm_race_pulls_log2_times_per_stage_and_keeps_no_snapshot(
        monkeypatch):
    """A racing stage of s steps pulls ⌈log₂ s⌉ times (chunks end at 2, 4,
    8, 16), and no slow-track carry outlives the race's need for it: at
    most four parameter trees made by a step are alive at once (the stage
    start, the old and new slow carry, the fast carry), whatever the
    chunk size; a snapshot per step of the chunk from 8 to 16 held ten."""
    import weakref

    from repro_torch.api import lm as tlm
    assert not hasattr(tengine, "RACE_SNAPSHOT_BYTES")
    spec = P.RunSpec.from_json(_lm_spec(
        "two_track", {"final_steps": 2, "max_stage_iters": 16,
                      "condition": "eval", "final_eval_full": True},
        n0=8).to_json())
    real, refs, alive = tlm.LMStepOptimizer.step, [], []

    def step(self, params, state, objective, data):
        out = real(self, params, state, objective, data)
        refs.append(weakref.ref(out[0]["final_norm"]))
        alive.append(sum(r() is not None for r in refs))
        return out

    monkeypatch.setattr(tlm.LMStepOptimizer, "step", step)
    sess = P.build(spec, device="cpu")
    tr = sess.run()
    stages = tr.column("stage")
    race = [stages.count(s) for s in sorted(set(stages))][:-1]
    assert race[0] == 16                 # the chunk from 8 to 16 ran
    pulls = [b["transfers"] - a["transfers"] for a, b in
             zip([{"transfers": 0}] + sess.stage_ends, sess.stage_ends)]
    assert pulls[:-1] == [math.ceil(math.log2(s)) for s in race]
    assert tr.meta["race_overshoot"] == 0
    assert max(alive) <= 4


def test_scan_stages_keep_no_stage_start_carry(monkeypatch):
    """Under fixed_steps a step's output replaces its input as the only
    live carry: the carry a stage started from is not held while its later
    steps run (on the full-width hybrid that stale carry of parameters and
    AdamW moments would be another 27.5 GB), so at most two parameter
    trees made by a step are alive at once."""
    import weakref

    from repro_torch.api import lm as tlm
    spec = P.RunSpec.from_json(_lm_spec(
        "fixed_steps", {"inner_steps": 3, "final_steps": 3}).to_json())
    real, refs, alive = tlm.LMStepOptimizer.step, [], []

    def step(self, params, state, objective, data):
        out = real(self, params, state, objective, data)
        refs.append(weakref.ref(out[0]["final_norm"]))
        alive.append(sum(r() is not None for r in refs))
        return out

    monkeypatch.setattr(tlm.LMStepOptimizer, "step", step)
    tr = P.build(spec, device="cpu").run()
    assert len(set(tr.column("stage"))) > 1 and len(alive) == 6
    assert max(alive) <= 2


def test_data_helpers_match_reference():
    corpus = twindow.synth_corpus(64, 17, 512, seed=3)
    np.testing.assert_array_equal(corpus, jwindow.synth_corpus(64, 17, 512,
                                                               seed=3))
    jtok, ttok = jnp.asarray(corpus[:20]), torch.from_numpy(corpus[:20])
    for t in (0, 3, 11):
        np.testing.assert_array_equal(
            tdw.rotation_rows(ttok, 8, torch.tensor(t, dtype=torch.int32)),
            np.asarray(jdw.rotation_rows(jtok, 8, jnp.int32(t))))
    for rows in (8, 30):
        np.testing.assert_array_equal(tdw.probe_rows(ttok, rows),
                                      np.asarray(jdw.probe_rows(jtok, rows)))


def test_configs_registry():
    cfg = tconfigs.get("falcon-mamba-7b")
    ref = jconfigs.get("falcon-mamba-7b")
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert cfg.dtype == torch.bfloat16
    assert tconfigs.get("falcon_mamba_7b") is cfg
    assert TT.vocab_padded(cfg) == JT.vocab_padded(ref) == 65024
    with pytest.raises(tconfigs.NotPortedError, match="moe slice"):
        tconfigs.get("granite-moe-1b-a400m")
    assert tconfigs.get("recurrentgemma-9b").family == "hybrid"
    with pytest.raises(KeyError, match="unknown architecture"):
        tconfigs.get("gpt-5")


def test_family_resolution():
    cfg = tconfigs.get("falcon-mamba-7b")
    fam = tfam.resolve_family(P.ModelSpec(arch="falcon-mamba-7b"), cfg)
    assert fam.name == "mamba" and fam.impl == "pallas"
    assert fam.kernels == ("ssm_scan",)
    assert tfam.resolve_family(
        P.ModelSpec(arch="falcon-mamba-7b", family="mamba"), cfg) is fam
    with pytest.raises(P.SpecError, match="cannot adapt"):
        tfam.resolve_family(P.ModelSpec(arch="falcon-mamba-7b",
                                        family="rglru"), cfg)
    with pytest.raises(P.SpecError, match="unknown model family"):
        tfam.resolve_family(P.ModelSpec(arch="falcon-mamba-7b",
                                        family="lstm"), cfg)
    moe = cfg.with_(family="moe")
    with pytest.raises(P.SpecError, match="not yet ported"):
        tfam.resolve_family(P.ModelSpec(arch="falcon-mamba-7b"), moe)


@pytest.mark.parametrize("change,needle", [
    (dict(model=None), "needs a ModelSpec"),
    (dict(optimizer=R.OptimizerSpec("newton_cg")), "trains through"),
    (dict(optimizer=R.OptimizerSpec("adamw_lm", {"b1": 0.8})),
     "accepts params"),
    (dict(model=R.ModelSpec(arch="gpt-5")), "unknown arch"),
    (dict(model=R.ModelSpec(arch="falcon-mamba-7b",
                            overrides={"dtype": "float33"})),
     "not a torch dtype"),
    (dict(model=R.ModelSpec(arch="falcon-mamba-7b",
                            overrides={"depth": 3})), "overrides"),
    (dict(model=R.ModelSpec(arch="qwen3-0.6b")), "transformer slice"),
], ids=["no_model", "optimizer", "opt_params", "arch", "dtype", "override",
        "pending_arch"])
def test_lm_validation(change, needle):
    spec = _lm_spec("fixed_steps", {}).replace(**change)
    with pytest.raises(P.SpecError, match=needle):
        P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
