"""The port's hybrid LM path (the rglru family: recurrentgemma-9b's
(rec, rec, attn) stack) against the reference, on the CPU: the config
and its reduced variant field for field, the loss and its gradients on
the reduced model in float32 with the reference's parameters carried
across (one super-block, and four layers so that the unrolled tail
runs), and ``build(RunSpec lm)`` under ``fixed_steps``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.workloads import families as jfam
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_leaves
from repro_torch.workloads import families as tfam

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# the bounds of tests/test_torch_lm.py: the float32 loss at 1e-5
# relative, f̂ after a few AdamW steps at 2e-5 relative; gradients (the
# same algorithm summed in other orders, entries up to ~1) within 1e-5
# absolute, the bound that file holds the first moments 0.1·g to at 1e-6
RTOL_LOSS = 1e-5
RTOL_F = 2e-5
ATOL_GRAD = 1e-5


def test_config_and_reduced_variant_match_reference():
    cfg, ref = tconfigs.get("recurrentgemma-9b"), jconfigs.get(
        "recurrentgemma-9b")
    for got, want in ((cfg, ref), (tconfigs.reduced(cfg),
                                   jconfigs.reduced(ref))):
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dtype == torch.bfloat16
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.lru_width, cfg.local_window, cfg.vocab_size) == \
        (4096, 16, 1, 256, 12288, 4096, 2048, 256000)
    assert tconfigs.get("recurrentgemma_9b") is cfg
    assert tconfigs.reduced(cfg).num_layers == 3
    fam = tfam.resolve_family(P.ModelSpec(arch="recurrentgemma-9b"), cfg)
    want = jfam.FAMILIES["rglru"]
    assert (fam.name, fam.impl, fam.kernels) == \
        (want.name, want.impl, want.kernels)


def _model(layers):
    jcfg = jconfigs.reduced(jconfigs.get("recurrentgemma-9b")).with_(
        dtype=jnp.float32, num_layers=layers)
    tcfg = tconfigs.reduced(tconfigs.get("recurrentgemma-9b")).with_(
        dtype=torch.float32, num_layers=layers)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(layers)))
    return jcfg, tcfg, params


def _batch(cfg, B=2, S=96, seed=0):
    """S = 96 > the reduced local window (64), so the window masks."""
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok[:, :-1]),
             "labels": jnp.asarray(tok[:, 1:])},
            {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])})


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict, in ``tree_leaves`` order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("layers", [3, 4])
def test_loss_and_gradients_match_reference(layers):
    """The reduced hybrid in float32 through the kernel route (rglru_scan
    and flash_attention, their plain versions here), with the reference's
    parameters: the loss within 1e-5 relative and every gradient within
    1e-5.  At 4 layers the fourth (a rec) is the unrolled tail."""
    jcfg, tcfg, params = _model(layers)
    assert TT.stack_counts(tcfg) == {"rec": layers - 1, "attn": 1}
    jb, tb = _batch(jcfg, seed=layers)

    def jloss(p):
        return JT.loss_fn(jcfg, p, jb, impl="pallas", remat=False)[0]

    want, jgrads = jax.device_get(jax.value_and_grad(jloss)(params))
    tp = convert.params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tops.reset_calls()
    got, _ = TT.loss_fn(tcfg, tp, tb, impl="pallas")
    grads = dict(zip(_flat(tp), torch.autograd.grad(got, leaves)))
    assert tops.CALLS == {}                    # the CPU launches nothing
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL_LOSS)
    jgrads = _flat(jgrads)
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=ATOL_GRAD,
                                   rtol=0, err_msg=name)


def test_hidden_forward_runs_the_tail_layers_in_pattern_order(monkeypatch):
    """Five layers: one super-block (rec 0, rec 1, attn 0), then the tail
    (rec 2, rec 3), each layer from its own slot of its stack."""
    _, tcfg, _ = _model(5)
    seen = []
    real = TT._layer_body

    def record(cfg, t, p, x, positions, impl):
        seen.append((t, float(p["norm1"][0])))
        return real(cfg, t, p, x, positions, impl)

    params = TT.init_params(tcfg, seed=0, device="cpu")
    for stack in (params["stack_rec"], params["stack_attn"]):
        stack["norm1"] += torch.arange(len(stack["norm1"]))[:, None]
    monkeypatch.setattr(TT, "_layer_body", record)
    _, tb = _batch(tcfg, S=8)
    TT.loss_fn(tcfg, params, tb, impl="pallas")
    assert seen == [("rec", 0.0), ("rec", 1.0), ("attn", 0.0), ("rec", 2.0),
                    ("rec", 3.0)]


def _lm_spec(policy, params, *, corpus=32, n0=16):
    return R.RunSpec(
        data=R.DataSpec(kind="lm", corpus_size=corpus, seq_len=16,
                        eval_rows=8),
        model=R.ModelSpec(arch="recurrentgemma-9b", reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=R.OptimizerSpec("adamw_lm", {"lr": 1e-3, "batch_size": 4}),
        policy=R.PolicySpec(policy, params),
        schedule=R.ScheduleSpec(n0=n0, step_cost="batch",
                                wait_on_expand=True, carry_state=True,
                                clock={"preloaded": n0}))


def test_lm_build_fixed_steps_matches_reference(monkeypatch):
    """build(RunSpec lm) on the reduced hybrid through both packages, the
    reference's parameters carried into the port's session: equal
    schedule, clock and access columns, f̂ within RTOL_F; and the two rec
    layers' scans and the attn layer's attention run once per forward
    pass (a train step and an f̂ probe per step) — the count
    chip_smoke.py holds the card's launches to."""
    spec = _lm_spec("fixed_steps", {"inner_steps": 3, "final_steps": 3})
    ref_sess = R.build(spec)
    ref = ref_sess.run()
    sess = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
    sess.w0 = convert.params_from_jax(jax.device_get(ref_sess.w0), "cpu")
    calls = {"rglru_scan": 0, "flash_attention": 0}
    for name in calls:
        def counting(*a, real=getattr(tops, name), name=name, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(tops, name, counting)
    port = sess.run()
    forward_passes = 2 * len(port.points)
    assert calls == {"rglru_scan": 2 * forward_passes,
                     "flash_attention": forward_passes}
    assert len(port.points) == len(ref.points) == 6
    for col in ("step", "stage", "window", "time", "accesses"):
        assert port.column(col) == ref.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(port.column(col), ref.column(col),
                                   rtol=RTOL_F)
    assert port.meta["arch"] == ref.meta["arch"] == "recurrentgemma-9b"
    assert port.meta["host_transfers"] == ref.meta["host_transfers"]
