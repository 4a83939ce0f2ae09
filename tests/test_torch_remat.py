"""Rematerialization on the port's LM paths, on the CPU: with ``remat``
on and off the reduced falcon-mamba-7b and recurrentgemma-9b give the
same loss and gradients bit for bit, and match the reference's (which
rematerializes by default); the cross-entropy keeps one chunk's logits
for the backward, not the whole sequence's; and each kernel inside a
rematerialized region runs once more per train step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_leaves

pytestmark = pytest.mark.tier1

# one intra-op thread: the suite's parallel workers do not oversubscribe
# the cores, and the CPU's embedding backward (a parallel scatter-add)
# then sums in one order
torch.set_num_threads(1)

# the bounds of tests/test_torch_lm.py and test_torch_hybrid.py: the
# float32 loss at 1e-5 relative, gradients within 1e-5 absolute
RTOL_LOSS = 1e-5
ATOL_GRAD = 1e-5

ARCHS = ["falcon-mamba-7b", "recurrentgemma-9b"]
# (arch, the kernel wrapper, layers of its type in the reduced model)
KERNELS = [("falcon-mamba-7b", "ssm_scan", 2),
           ("recurrentgemma-9b", "rglru_scan", 2),
           ("recurrentgemma-9b", "flash_attention", 1)]


def _model(arch, layers=None):
    jcfg = jconfigs.reduced(jconfigs.get(arch)).with_(dtype=jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get(arch)).with_(dtype=torch.float32)
    if layers is not None:
        jcfg, tcfg = (c.with_(num_layers=layers) for c in (jcfg, tcfg))
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(7)))
    return jcfg, tcfg, params


def _batch(cfg, B=2, S=96, seed=0):
    """S = 96 exceeds the reduced hybrid's local window (64)."""
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok[:, :-1]),
             "labels": jnp.asarray(tok[:, 1:])},
            {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])})


def _loss_and_grads(tcfg, params, batch, remat):
    tp = convert.params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    loss, _ = TT.loss_fn(tcfg, tp, batch, impl="pallas", remat=remat)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,layers", [(ARCHS[0], None), (ARCHS[1], None),
                                         (ARCHS[1], 4)],
                         ids=["mamba", "hybrid", "hybrid_tail"])
def test_remat_on_and_off_give_the_same_bits(arch, layers):
    """At 4 hybrid layers the fourth (a rec) is the tail, which is not
    rematerialized, after a rematerialized super-block."""
    _, tcfg, params = _model(arch, layers)
    _, tb = _batch(tcfg)
    on, g_on = _loss_and_grads(tcfg, params, tb, True)
    off, g_off = _loss_and_grads(tcfg, params, tb, False)
    assert torch.equal(on, off)
    assert len(g_on) == len(g_off) == len(tree_leaves(params))
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS, ids=["mamba", "hybrid"])
def test_remat_matches_the_reference(arch):
    """The loss and every gradient against the reference's, both
    rematerializing (its default)."""
    jcfg, tcfg, params = _model(arch)
    jb, tb = _batch(jcfg, seed=3)

    def jloss(p):
        return JT.loss_fn(jcfg, p, jb, impl="pallas", remat=True)[0]

    want, jgrads = jax.device_get(jax.value_and_grad(jloss)(params))
    got, grads = _loss_and_grads(tcfg, params, tb, True)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL_LOSS)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), jg, atol=ATOL_GRAD, rtol=0)


def _saved_bytes(fn) -> int:
    """Bytes of the tensors autograd keeps for the backward while ``fn``
    runs (each storage counted once)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_lm_loss_keeps_one_chunk_of_logits(monkeypatch):
    """B 2, S 2048, vocabulary 4096 in chunks of 512: the backward keeps
    at most one chunk's float32 logits (2 x 512 x 4096 x 4 B = 16 MiB),
    where the same loss without the chunks rematerialized keeps all four
    (64 MiB)."""
    B, S, d, V, chunk = 2, 2048, 16, 4096, 512
    cfg = tconfigs.reduced(tconfigs.get("falcon-mamba-7b")).with_(
        dtype=torch.float32, vocab_size=V)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((B, S, d), generator=gen, requires_grad=True)
    head = torch.randn((d, V), generator=gen, requires_grad=True)
    labels = torch.randint(0, V, (B, S), generator=gen)

    def loss():
        return TT.lm_loss(cfg, h, head, labels, chunk=chunk)

    full, one_chunk = B * S * V * 4, B * chunk * V * 4
    kept = _saved_bytes(loss)
    assert kept <= one_chunk
    monkeypatch.setattr(TT, "_remat", lambda fn, *args: fn(*args))
    assert _saved_bytes(loss) >= full
    monkeypatch.undo()
    # and the value and gradients are those of the plain chunks
    out = loss()
    g = torch.autograd.grad(out, (h, head))
    monkeypatch.setattr(TT, "_remat", lambda fn, *args: fn(*args))
    out2 = loss()
    g2 = torch.autograd.grad(out2, (h, head))
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(g, g2))


@pytest.mark.parametrize("arch,kernel,layers", KERNELS,
                         ids=[k[1] for k in KERNELS])
def test_train_step_runs_each_kernel_once_more(arch, kernel, layers,
                                               monkeypatch):
    """A train step with remat runs each kernel of a rematerialized region
    twice (the forward pass and its recomputation inside the backward),
    once without — the counts chip_smoke.py holds the card's launches
    to."""
    _, tcfg, params = _model(arch)
    _, tb = _batch(tcfg, S=64)
    calls = []
    real = getattr(tops, kernel)
    monkeypatch.setattr(tops, kernel,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tp = convert.params_from_jax(params, "cpu")
    for remat, per_layer in ((True, 2), (False, 1)):
        del calls[:]
        step = tsteps.make_train_step(tcfg, impl="pallas", remat=remat)
        step(tp, tsteps.init_opt_state(tp), tb)
        assert len(calls) == per_layer * layers, remat
