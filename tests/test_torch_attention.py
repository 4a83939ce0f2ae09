"""Kernel B2 (blocked flash attention) of the port against the reference,
on the CPU: the plain version behind ``repro_torch.kernels.ops.
flash_attention`` against ``repro.kernels.ops.flash_attention`` (the
Pallas kernel in interpret mode, as the reference's own tests run it) on
the sweep of ``tests/test_kernels.py`` (GQA ratios 1, 2 and 8, sequences
that are not a block multiple), with local windows, and backward in q, k
and v through the port's ``torch.autograd.Function``; then RoPE,
``qkv_project`` and ``attention_block`` on the reduced recurrentgemma-9b
with the reference's parameters carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# the reference's own bounds (tests/test_kernels.py): f32 1e-4, bf16 2e-2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _qkv(B, H, KV, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, hd)).astype(np.float32)
            for n in (H, KV, KV)]


def _both(arrays, dtype):
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 64, 32), (2, 4, 2, 128, 64), (1, 8, 1, 96, 64),
    (2, 3, 3, 160, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_attention_matches_reference(B, H, KV, S, hd, dtype):
    j, t = _both(_qkv(B, H, KV, S, hd, seed=B + H + S), dtype)
    want = jops.flash_attention(*j, causal=True, block_q=32, block_k=32)
    got = tops.flash_attention(*t, causal=True)
    assert got.dtype == t[0].dtype and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("window", [16, 48])
@pytest.mark.parametrize("KV", [2, 1])
def test_plain_flash_attention_local_window(window, KV):
    j, t = _both(_qkv(1, 2, KV, 96, 32, seed=window + KV), "float32")
    want = jops.flash_attention(*j, causal=True, window=window, block_q=32,
                                block_k=32)
    got = tops.flash_attention(*t, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the window masks: the windowed output differs from the causal one
    full = tops.flash_attention(*t, causal=True)
    assert float((got - full).abs().max()) > 1e-2


@pytest.mark.parametrize("window", [0, 16])
def test_flash_attention_grad_matches_reference(window):
    """The backward pass (the plain version's VJP, recomputed from the
    saved inputs, GQA ratio 2) against jax.grad of the Pallas path, at
    the reference's 1e-3."""
    q, k, v = _qkv(1, 2, 1, 64, 32, seed=11 + window)

    def jloss(q, k, v):
        return (jops.flash_attention(q, k, v, causal=True, window=window,
                                     block_q=32, block_k=32) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tops.flash_attention(*t, causal=True, window=window) ** 2).sum() \
        .backward()
    for got, w in zip(t, want):
        assert got.grad.shape == w.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-3, atol=1e-3)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 32, 32, seed=0))
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="multiple of KV"):
        tfa.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match=r"\(B, S, KV, hd\)"):
        tfa.flash_attention(q, k[:, :16], v)
    tops.reset_calls()
    tops.flash_attention(q, k, v)
    assert tops.CALLS["flash_attention"] == 0


def test_plain_version_in_float64_matches_float32():
    """The card's accuracy check runs the plain version in float64."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 1, 80, 32, seed=5))
    np.testing.assert_allclose(
        tref.gqa_attention(q.double(), k.double(), v.double(), window=24),
        tref.gqa_attention(q, k, v, window=24).double(), rtol=1e-5,
        atol=1e-5)


# ------------------------------------------------------------ model pieces
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference(theta):
    """RoPE rotates the two halves of the head dimension."""
    x = np.random.default_rng(0).standard_normal((2, 12, 3, 16)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_causal_mask_bias_matches_reference(window):
    pos = np.arange(9)
    want = jlayers.causal_mask_bias(jnp.asarray(pos[2:6]), jnp.asarray(pos),
                                    window)
    got = tlayers.causal_mask_bias(torch.from_numpy(pos[2:6]),
                                   torch.from_numpy(pos), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def attn_layer():
    """The reduced recurrentgemma-9b in float32 and its ``attn`` layer of
    the reference's parameters, in both packages."""
    jcfg = jconfigs.reduced(jconfigs.get("recurrentgemma-9b")).with_(
        dtype=jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get("recurrentgemma-9b")).with_(
        dtype=torch.float32)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(0)))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["stack_attn"])
    return jcfg, tcfg, jp, convert.params_from_jax(jp, "cpu")


def _x_pos(B, S, d, seed):
    x = np.random.default_rng(seed).standard_normal((B, S, d)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return x, pos


def test_qkv_project_matches_reference(attn_layer):
    jcfg, tcfg, jp, tp = attn_layer
    x, pos = _x_pos(2, 24, tcfg.d_model, seed=1)
    want = jattn.qkv_project(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.qkv_project(tcfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("S", [128, 96])
def test_attention_block_matches_reference(attn_layer, impl, S):
    """The local-attention sub-layer with the reduced config's window (64)
    on sequences longer than it, through both routes, float32.  S = 96 is
    not a multiple of the Pallas block, so the reference pads."""
    jcfg, tcfg, jp, tp = attn_layer
    assert tcfg.local_window == 64 < S
    x, pos = _x_pos(2, S, tcfg.d_model, seed=S)
    want = jattn.attention_block(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                 impl=impl, window=jcfg.local_window)
    got = tattn.attention_block(tcfg, tp, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()), impl=impl,
                                window=tcfg.local_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
