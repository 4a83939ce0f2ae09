"""The port's serving path against the reference, on the CPU: prefill's
logits and cache and one decode step's logits for qwen3-0.6b,
granite-moe-1b-a400m (high capacity), falcon-mamba-7b, recurrentgemma-9b
and qwen2-vl-2b reduced, in float32 with the reference's parameters
carried across (its Pallas kernels in interpret mode under
``impl="pallas"``); the reference's own consistency tests
(``tests/test_serving.py``) on the port in bfloat16; the mamba kernel skip
under ``return_state`` and the RG-LRU ``h`` quirk; greedy ``generate``
token for token; and sampled generation's generator threading."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

B, S = 2, 32
# port against reference in float32: the reference test's tightest bound
# (1e-4 relative to the largest logit), which covers its looser ones for
# the vlm (1e-3) and the hybrid (0.03); measured ~2e-6
RTOL_F32 = 1e-4

# (arch, overrides, impls): the impls of the family's train path
CASES = [
    ("qwen3_0p6b", {}, ("xla",)),
    ("granite_moe_1b_a400m", {"capacity_factor": 8.0}, ("xla",)),
    ("falcon_mamba_7b", {}, ("xla", "pallas")),
    ("recurrentgemma_9b", {}, ("xla", "pallas")),
    ("qwen2_vl_2b", {}, ("xla",)),
]


def _configs(arch, dtype="float32", **kw):
    jcfg = jconfigs.reduced(jconfigs.get(arch)).with_(
        dtype=getattr(jnp, dtype), **kw)
    tcfg = tconfigs.reduced(tconfigs.get(arch)).with_(
        dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _params(jcfg, seed=1):
    jp = JT.init_params(jcfg, jax.random.key(seed))
    return jp, convert.params_from_jax(jax.device_get(jp), device="cpu")


def _batches(cfg, s, seed=0, dtype=np.float32):
    """Numpy inputs of s + 1 positions: tokens, or random embeds with
    M-RoPE positions (t = h = w = position, as the reference test)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        tok = rng.integers(0, min(cfg.vocab_size, 512),
                           (B, s + 1)).astype(np.int32)
        return {"tokens": tok}
    emb = rng.standard_normal((B, s + 1, cfg.d_model)).astype(dtype)
    pos = np.broadcast_to(np.arange(s + 1, dtype=np.int32)[None, None],
                          (3, B, s + 1)).copy()
    return {"embeds": emb, "positions": pos}


def _prefix(batch, n):
    out = {"tokens": batch["tokens"][:, :n]} if "tokens" in batch else \
        {"embeds": batch["embeds"][:, :n],
         "positions": batch["positions"][:, :, :n]}
    return out


def _step(batch, s):
    out = {"tokens": batch["tokens"][:, s:s + 1]} if "tokens" in batch \
        else {"embeds": batch["embeds"][:, s:s + 1]}
    return out


def _jax(batch, jcfg):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].astype(jcfg.dtype)
    return out


def _torch(batch, tcfg):
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].to(tcfg.dtype)
    if "positions" in out:
        out["positions"] = out["positions"].long()
    return out


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("arch,kw,impl", [
    (a, kw, impl) for a, kw, impls in CASES for impl in impls],
    ids=[f"{a}-{impl}" for a, _, impls in CASES for impl in impls])
def test_prefill_and_decode_match_reference(arch, kw, impl):
    """Prefill's last logits and every cache tensor, then one decode step
    from that cache, port against reference (float32, 1e-4 relative)."""
    jcfg, tcfg = _configs(arch, **kw)
    jp, tp = _params(jcfg)
    batch = _batches(jcfg, S)
    jl, jcache = JT.prefill_step(jcfg, jp, _jax(_prefix(batch, S), jcfg),
                                 impl=impl, cache_len=S + 8)
    tl, tcache = TT.prefill_step(tcfg, tp, _torch(_prefix(batch, S), tcfg),
                                 impl=impl, cache_len=S + 8)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert _rel(tl, jl) < RTOL_F32
    jc = jax.device_get(jcache)
    assert set(tcache) == set(jc)
    for stack, leaves in jc.items():
        assert set(tcache[stack]) == set(leaves)
        for k, want in leaves.items():
            got = tcache[stack][k]
            assert tuple(got.shape) == want.shape, (stack, k)
            assert _rel(got.float(), want) < RTOL_F32, (stack, k)
    jd, _ = JT.decode_step(jcfg, jp, jcache,
                           {**_jax(_step(batch, S), jcfg),
                            "position": jnp.int32(S)})
    td, _ = TT.decode_step(tcfg, tp, tcache,
                           {**_torch(_step(batch, S), tcfg), "position": S})
    assert _rel(td, jd) < RTOL_F32


def test_init_cache_matches_reference_layout():
    for arch, kw, _ in CASES:
        jcfg, tcfg = _configs(arch, **kw)
        want = JT.init_cache(jcfg, 3, 40, abstract=True)
        got = TT.init_cache(tcfg, 3, 40, device="cpu")
        assert set(got) == set(want)
        for stack, leaves in want.items():
            for k, spec in leaves.items():
                assert tuple(got[stack][k].shape) == spec.shape, (arch, k)
                assert not got[stack][k].any()


# ------------------------------------------------ the reference's own tests
EXACT = ["internlm2_1p8b", "yi_9b", "stablelm_12b", "qwen3_0p6b",
         "musicgen_medium", "falcon_mamba_7b"]
APPROX = ["recurrentgemma_9b"]     # streaming-conv path differs in bf16


def _consistency(tcfg, tp, batch, s, cache_len):
    """(logits of a prefill of s + 1 positions, prefill of s then one
    decode step), the port alone."""
    ref, _ = TT.prefill_step(tcfg, tp, _torch(_prefix(batch, s + 1), tcfg),
                             cache_len=cache_len)
    _, cache = TT.prefill_step(tcfg, tp, _torch(_prefix(batch, s), tcfg),
                               cache_len=cache_len)
    dec, _ = TT.decode_step(tcfg, tp, cache,
                            {**_torch(_step(batch, s), tcfg), "position": s})
    return ref, dec


@pytest.mark.parametrize("arch", EXACT + APPROX)
def test_prefill_decode_consistency(arch):
    """tests/test_serving.py's consistency on the port, bfloat16, at the
    reference's bounds: 1e-4 relative (0.03 for the hybrid)."""
    _, tcfg = _configs(arch, "bfloat16")
    tp = TT.init_params(tcfg, 1, device="cpu")
    ref, dec = _consistency(tcfg, tp, _batches(tcfg, S), S, S + 8)
    assert _rel(dec, ref) < (0.03 if arch in APPROX else 1e-4)


def test_prefill_decode_consistency_moe_high_capacity():
    _, tcfg = _configs("granite_moe_1b_a400m", "bfloat16",
                       capacity_factor=8.0)
    tp = TT.init_params(tcfg, 1, device="cpu")
    ref, dec = _consistency(tcfg, tp, _batches(tcfg, S), S, S + 8)
    assert float((ref - dec).abs().max()) < 1e-4


def test_vlm_prefill_decode_consistency():
    _, tcfg = _configs("qwen2_vl_2b", "bfloat16")
    tp = TT.init_params(tcfg, 1, device="cpu")
    ref, dec = _consistency(tcfg, tp, _batches(tcfg, S), S, S + 8)
    assert _rel(dec, ref) < 1e-3


def test_sliding_window_ring_buffer_after_it_wraps():
    """A ring-buffer cache of 16 slots after 40 tokens: decode equals the
    windowed forward's last logits (bfloat16, 1e-4), and against the
    reference (float32, 1e-4) the cache holds the same rows in the same
    slots."""
    _, tcfg = _configs("internlm2_1p8b", "bfloat16", sliding_window=16)
    tp = TT.init_params(tcfg, 1, device="cpu")
    total = 40
    batch = _batches(tcfg, total, seed=9)
    ref, dec = _consistency(tcfg, tp, batch, total, total + 8)
    assert _rel(dec, ref) < 1e-4

    jcfg, tcfg = _configs("internlm2_1p8b", sliding_window=16)
    jp, tp = _params(jcfg)
    _, jcache = JT.prefill_step(jcfg, jp, _jax(_prefix(batch, total), jcfg),
                                cache_len=total + 8)
    _, tcache = TT.prefill_step(tcfg, tp, _torch(_prefix(batch, total), tcfg),
                                cache_len=total + 8)
    for step in range(3):           # slots 8, 9, 10 of the 16-slot ring
        pos = total + step
        nxt = {"tokens": batch["tokens"][:, step:step + 1]}
        jl, jcache = JT.decode_step(jcfg, jp, jcache,
                                    {**_jax(nxt, jcfg),
                                     "position": jnp.int32(pos)})
        tl, tcache = TT.decode_step(tcfg, tp, tcache,
                                    {**_torch(nxt, tcfg), "position": pos})
        assert _rel(tl, jl) < RTOL_F32
    jk = np.asarray(jax.device_get(jcache)["stack_attn_mlp"]["k"])
    assert jk.shape[2] == 16
    assert _rel(tcache["stack_attn_mlp"]["k"], jk) < RTOL_F32


# ------------------------------------------------------------------ quirks
def test_prefill_skips_the_scan_kernel_under_return_state(monkeypatch):
    """mamba.py:82: ``return_state`` takes the plain scan, so prefill with
    impl="pallas" never calls B3, while a train forward does; the
    prefill's logits equal the xla prefill's bit for bit."""
    _, tcfg = _configs("falcon_mamba_7b")
    tp = TT.init_params(tcfg, 1, device="cpu")
    batch = _torch(_prefix(_batches(tcfg, S), S), tcfg)
    xla, _ = TT.prefill_step(tcfg, tp, batch, impl="xla")
    calls = []
    real = tops.ssm_scan

    def counted(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(tops, "ssm_scan", counted)
    pallas, _ = TT.prefill_step(tcfg, tp, batch, impl="pallas")
    assert not calls
    assert torch.equal(pallas, xla)
    x, pos = TT.embed_inputs(tcfg, tp, batch)
    TT.hidden_forward(tcfg, tp, x, pos, impl="pallas", remat=False)
    assert len(calls) == tcfg.num_layers


def test_rglru_h_comes_from_the_cast_output_under_pallas():
    """rglru.py:38: impl="pallas" returns h_final as the last row of the
    scan's dtype-cast output; the loop returns its float32 carry.  Both
    against the reference (bfloat16 input), and prefill, which passes no
    impl to the Griffin block, carries the loop's h under either impl."""
    jcfg, tcfg = _configs("recurrentgemma_9b", "bfloat16")
    jp, tp = _params(jcfg)
    layer_j = jax.tree_util.tree_map(lambda a: a[0], jp["stack_rec"])
    layer_t = {k: v[0] for k, v in tp["stack_rec"].items()}
    x = np.random.default_rng(3).standard_normal(
        (B, 24, tcfg.lru_width)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)
    for impl in ("xla", "pallas"):
        _, jh = JR.rg_lru(layer_j, xj, impl=impl)
        y, th = TR.rg_lru(layer_t, xt, impl=impl)
        assert th.dtype == torch.float32
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-2,
                                   atol=2e-2)
        if impl == "pallas":
            assert torch.equal(th, y[:, -1].float())
        else:                       # the carry, not its bfloat16 rounding
            assert not torch.equal(th, y[:, -1].float())
    batch = _torch(_prefix(_batches(tcfg, S), S), tcfg)
    _, c_xla = TT.prefill_step(tcfg, tp, batch, impl="xla")
    _, c_pallas = TT.prefill_step(tcfg, tp, batch, impl="pallas")
    assert torch.equal(c_xla["stack_rec"]["h"], c_pallas["stack_rec"]["h"])


# -------------------------------------------------------------- generation
def _prompts(n=16, seed=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (2, n)).astype(np.int32)


def test_greedy_generate_matches_reference_token_for_token():
    jcfg, tcfg = _configs("qwen3_0p6b")
    jp, tp = _params(jcfg, seed=0)
    prompts = _prompts()
    want = np.asarray(jserve.generate(jcfg, jp, jnp.asarray(prompts),
                                      gen_tokens=8))
    got = tserve.generate(tcfg, tp, torch.from_numpy(prompts), gen_tokens=8)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    again = tserve.generate(tcfg, tp, torch.from_numpy(prompts),
                            gen_tokens=8)
    assert torch.equal(got, again)


def test_sampled_generate_threads_the_generator():
    """The same generator seed gives the same tokens, another seed others
    (at reduced scale the logits are near-uniform)."""
    _, tcfg = _configs("qwen3_0p6b", "bfloat16")
    tp = TT.init_params(tcfg, 0, device="cpu")
    prompts = torch.from_numpy(_prompts())

    def sample(seed):
        return tserve.generate(tcfg, tp, prompts, gen_tokens=8, greedy=False,
                               generator=torch.Generator().manual_seed(seed))
    s1, s2, s3 = sample(5), sample(5), sample(6)
    assert torch.equal(s1, s2)
    assert not torch.equal(s1, s3)
    assert int(s1.max()) < tcfg.vocab_size


def test_generate_sliding_window_cache_matches_full_cache():
    """Prompt and generation inside the window: the ring never evicts live
    context, so the windowed config generates what its twin does."""
    _, base = _configs("internlm2_1p8b", "bfloat16")
    windowed = base.with_(sliding_window=24)
    tp = TT.init_params(base, 1, device="cpu")
    prompts = torch.from_numpy(_prompts(12))
    full = tserve.generate(base, tp, prompts, gen_tokens=8)
    ring = tserve.generate(windowed, tp, prompts, gen_tokens=8)
    assert torch.equal(full, ring)
