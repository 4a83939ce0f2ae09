"""The port's transformer and moe families against the reference, on the
CPU: the ten architectures' configs and reduced variants field for field,
M-RoPE and qk-norm in ``qkv_project``, ``loss_fn`` of each of the eight
architectures of these families on ``configs.reduced(...)`` (float32 and
bfloat16) with the reference's parameters carried across, and one train
step of qwen3-0.6b and granite-moe-1b-a400m."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# the bounds of tests/test_torch_lm.py: the float32 loss at 1e-5
# relative; bfloat16 at 5e-3 (the frameworks round activations to
# bfloat16 at different places; bfloat16 keeps 2^-8 = 3.9e-3); the train
# step's scalars (loss, gradient norm, aux terms) at 1e-5
RTOL_LOSS = 1e-5
RTOL_BF16 = 5e-3
RTOL_STEP = 1e-5

# the architectures of the transformer (dense, vlm, audio) and moe
# families
ARCHS = ["qwen3-0.6b", "internlm2-1.8b", "yi-9b", "stablelm-12b",
         "musicgen-medium", "qwen2-vl-2b", "granite-moe-1b-a400m",
         "llama4-scout-17b-a16e"]


def _fields_equal(got, want):
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_and_reduced_variants_match_reference(arch):
    cfg, ref = tconfigs.get(arch), jconfigs.get(arch)
    _fields_equal(cfg, ref)
    _fields_equal(tconfigs.reduced(cfg), jconfigs.reduced(ref))
    assert cfg.dtype == torch.bfloat16
    assert TT.vocab_padded(cfg) == JT.vocab_padded(ref)


def test_registry_lists_every_architecture():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    every = tconfigs.all_configs()
    assert list(every) == tconfigs.ARCH_IDS
    assert every["qwen3_0p6b"] is tconfigs.get("qwen3-0.6b")
    with pytest.raises(KeyError, match="unknown architecture"):
        tconfigs.get("gpt-5")


def test_apply_mrope_matches_reference():
    """Three position streams over the (8, 12, 12) sections of a 64-wide
    head, float32, against the reference at 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 40, (3, 2, 16)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (8, 12, 12))
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         (8, 12, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="sum to half"):
        TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       (8, 12, 10))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-vl-2b"])
def test_qkv_project_matches_reference(arch):
    """qk-norm (RMS over the head dim with its float32 scale) then RoPE,
    and M-RoPE with (3, B, S) positions, in the reference's order."""
    jcfg = jconfigs.reduced(jconfigs.get(arch)).with_(dtype=jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get(arch)).with_(dtype=torch.float32)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(3)))
    p = {k: v[0] for k, v in params["stack_attn_mlp"].items()}
    if jcfg.qk_norm:
        rng = np.random.default_rng(1)
        for k in ("q_norm", "k_norm"):
            p[k] = rng.standard_normal(p[k].shape).astype(np.float32) * 0.1
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    if jcfg.mrope:
        pos = rng.integers(0, 8, (3, 2, 8)).astype(np.int32)
    else:
        pos = np.broadcast_to(np.arange(8), (2, 8)).astype(np.int32)
    want = JA.qkv_project(jcfg, p, jnp.asarray(x), jnp.asarray(pos))
    got = TA.qkv_project(tcfg, convert.params_from_jax(p, "cpu"),
                         torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _batch(cfg, B=2, S=32, seed=0):
    """Tokens and labels from ``seed``; for embedding inputs ``embeds``
    and, under M-RoPE, (3, B, S) positions (t the index, h and w
    random)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.input_mode == "embeddings":
        arrays["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        arrays["positions"] = np.stack(
            [np.broadcast_to(np.arange(S), (B, S)),
             rng.integers(0, 8, (B, S)),
             rng.integers(0, 8, (B, S))]).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in arrays.items()})


def _model(arch, jdtype, tdtype, seed=0):
    jcfg = jconfigs.reduced(jconfigs.get(arch)).with_(dtype=jdtype)
    tcfg = tconfigs.reduced(tconfigs.get(arch)).with_(dtype=tdtype)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(seed)))
    return jcfg, tcfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, dtype):
    """The whole reduced model with the reference's parameters carried
    across: the loss and every metric (a moe stack's aux terms too)."""
    jcfg, tcfg, params = _model(arch, getattr(jnp, dtype),
                                getattr(torch, dtype))
    jb, tb = _batch(jcfg)
    want, jm = JT.loss_fn(jcfg, params, jb)
    got, tm = TT.loss_fn(tcfg, convert.params_from_jax(params, "cpu"), tb)
    rtol = RTOL_LOSS if dtype == "float32" else RTOL_BF16
    assert got.dtype == torch.float32
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(got.item(), float(want), rtol=rtol)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    if jcfg.family == "moe":
        assert sorted(tm) == ["ce_loss", "load_balance", "router_z"]
        np.testing.assert_allclose(
            got.item(), (tm["ce_loss"] + 0.01 * tm["load_balance"]
                         + 0.001 * tm["router_z"]).item(), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_train_step_matches_reference(arch):
    """One AdamW step (lr 1e-3, weight decay 0.1) in float32: the loss,
    the gradient norm and the aux terms at 1e-5."""
    jcfg, tcfg, params = _model(arch, jnp.float32, torch.float32, seed=4)
    jb, tb = _batch(jcfg, seed=5)
    jstep = jsteps.make_train_step(jcfg, lr=1e-3)
    _, _, jm = jax.device_get(jstep(params, jsteps.init_opt_state(params),
                                    jb))
    tp = convert.params_from_jax(params, "cpu")
    tstep = tsteps.make_train_step(tcfg, lr=1e-3)
    _, _, tm = tstep(tp, tsteps.init_opt_state(tp), tb)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                   rtol=RTOL_STEP, err_msg=k)
        assert not tm[k].requires_grad
    if jcfg.family == "moe":
        assert {"load_balance", "router_z"} <= set(tm)


def test_embedding_inputs_take_the_batch_embeds():
    """qwen2-vl's ``input_mode="embeddings"``: no embedding table, the
    batch's embeds cast to the config's dtype, the (3, B, S) positions
    passed through."""
    cfg = tconfigs.reduced(tconfigs.get("qwen2-vl-2b"))
    params = TT.init_params(cfg, 0, device="cpu")
    assert "embed" not in params
    _, tb = _batch(cfg)
    x, positions = TT.embed_inputs(cfg, params, tb)
    assert x.dtype == torch.bfloat16 and x.shape == (2, 32, cfg.d_model)
    assert positions is tb["positions"]
    with pytest.raises(KeyError, match="embeds"):
        TT.embed_inputs(cfg, params, {"tokens": tb["tokens"]})
