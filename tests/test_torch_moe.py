"""The port's mixture-of-experts layer against the reference, on the CPU:
the capacity, ``route`` (dispatch masks bit for bit, the combine weights
and the aux losses at 1e-6, with and without dropped slots, top-k ties
broken to the lower expert), ``moe_block`` (with the shared expert too), its
parameters carried across in their dtypes, and the moe stack's loss and
gradients bit for bit with remat on and off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_leaves

pytestmark = pytest.mark.tier1

# one intra-op thread: the suite's parallel workers do not oversubscribe
# the cores, and the CPU's embedding backward then sums in one order
torch.set_num_threads(1)

# route's float32 outputs: the combine weights are the same gate values
# (a softmax, a top-k, a renormalization), the aux terms means over them;
# measured within 1.2e-7, so 1e-6
TOL_ROUTE = 1e-6
# moe_block's output and the aux terms in float32, the loss's bound of
# tests/test_torch_lm.py; the output's entries (up to ~2) sum d·f
# products in other orders, so also 1e-5 absolute (measured 1.4e-6)
RTOL_BLOCK = 1e-5
ATOL_BLOCK = 1e-5


def _cfgs(arch, **kw):
    jcfg = jconfigs.reduced(jconfigs.get(arch)).with_(dtype=jnp.float32,
                                                       **kw)
    tcfg = tconfigs.reduced(tconfigs.get(arch)).with_(dtype=torch.float32,
                                                       **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("s_g", [1, 7, 64, 512])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e"])
def test_capacity_matches_reference(arch, s_g):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert TM._capacity(tcfg, s_g) == JM._capacity(jcfg, s_g)


def _route_inputs(d, E, G=2, S=64, seed=0, router=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, S, d)).astype(np.float32)
    w = rng.standard_normal((d, E)).astype(np.float32) * d ** -0.5 \
        if router is None else router
    return x, w


def _route_both(jcfg, tcfg, x, w):
    want = jax.device_get(JM.route(jcfg, jnp.asarray(w), jnp.asarray(x)))
    got = TM.route(tcfg, torch.from_numpy(w), torch.from_numpy(x))
    return want, got


def _check_route(want, got):
    (jc, jd, ja), (tc, td, ta) = want, got
    assert td.dtype == torch.float32 and tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=TOL_ROUTE)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(ta[k].item(), float(ja[k]),
                                   rtol=TOL_ROUTE, err_msg=k)


@pytest.mark.parametrize("arch,E,K", [
    ("granite-moe-1b-a400m", 4, 2),      # the reduced variant
    ("granite-moe-1b-a400m", 32, 8),     # the published routing
    ("llama4-scout-17b-a16e", 16, 1),
])
def test_route_matches_reference(arch, E, K):
    jcfg, tcfg = _cfgs(arch, num_experts=E, experts_per_token=K)
    x, w = _route_inputs(jcfg.d_model, E)
    want, got = _route_both(jcfg, tcfg, x, w)
    _check_route(want, got)
    C = JM._capacity(jcfg, 64)
    assert got[0].shape == (2, 64, E, C)


def test_route_drops_what_exceeds_capacity():
    """A router that sends every token to expert 0: expert 0's queue is
    full after C tokens, the rest of its slots are dropped, and the other
    slot's tie among experts 1..3 goes to expert 1, as in the reference."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    E = jcfg.num_experts
    router = np.zeros((jcfg.d_model, E), np.float32)
    x, _ = _route_inputs(jcfg.d_model, E, seed=1)
    # every token's logit for expert 0 is mean |x| ~ 0.8, the others'
    # exactly 0: expert 0 first, then a three-way tie of equal, non-zero
    # probabilities (a gate of 0 would not be dispatched)
    x = np.abs(x)
    router[:, 0] = 1.0 / jcfg.d_model
    want, got = _route_both(jcfg, tcfg, x, router)
    _check_route(want, got)
    C = JM._capacity(jcfg, 64)
    dispatch = got[1]
    assert int(dispatch[:, :, 0].sum()) == 2 * C          # C of 64 kept
    assert int(dispatch[:, :, 1].sum()) == 2 * C           # the tie's
    assert int(dispatch[:, :, 2:].sum()) == 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e"])
def test_moe_block_matches_reference(arch):
    """granite-moe reduced (top-2) and llama4-scout reduced (top-1 with a
    shared SwiGLU expert): the output, the aux terms, and the gradients
    with respect to the router and the input.  Under top-1 the
    renormalized gate is g / g = 1, so the output's gradient with respect
    to the router is rounding noise in either framework: there the
    router's gradient is the aux terms' alone."""
    jcfg, tcfg = _cfgs(arch)
    assert bool(jcfg.shared_expert) == (arch == "llama4-scout-17b-a16e")
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(2)))
    p = {k: v[0] for k, v in params["stack_moe"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 48, jcfg.d_model)).astype(np.float32)
    top1 = jcfg.experts_per_token == 1

    def jf(router, x):
        y, aux = JM.moe_block(jcfg, dict(p, router=router), x)
        out = aux["load_balance"] + aux["router_z"]
        return out + jnp.sum((jax.lax.stop_gradient(y) if top1 else y)
                             ** 2), (y, aux)

    def jfx(x):
        y, aux = JM.moe_block(jcfg, p, x)
        return jnp.sum(y ** 2) + aux["load_balance"]

    (_, (jy, jaux)), jgr = jax.value_and_grad(jf, has_aux=True)(
        p["router"], jnp.asarray(x))
    jgx = jax.grad(jfx)(jnp.asarray(x))
    tp = convert.params_from_jax(p, "cpu")
    router = tp["router"].requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TM.moe_block(tcfg, tp, tx)
    out = taux["load_balance"] + taux["router_z"]
    gr, = torch.autograd.grad(
        out + torch.sum((ty.detach() if top1 else ty) ** 2), [router],
        retain_graph=True)
    gx, = torch.autograd.grad(torch.sum(ty ** 2) + taux["load_balance"],
                              [tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=RTOL_BLOCK, atol=ATOL_BLOCK)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   rtol=RTOL_BLOCK, err_msg=k)
    np.testing.assert_allclose(gr.numpy(), np.asarray(jgr), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)


def test_moe_params_carry_across_in_their_dtypes():
    """The reference's bfloat16 moe tree: the router arrives in float32,
    the experts in bfloat16 with every value kept, in the port's layout."""
    jcfg = jconfigs.reduced(jconfigs.get("granite-moe-1b-a400m"))
    tcfg = tconfigs.reduced(tconfigs.get("granite-moe-1b-a400m"))
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(1)))
    carried = convert.params_from_jax(params, "cpu")
    stack = carried["stack_moe"]
    assert stack["router"].dtype == torch.float32
    assert stack["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        stack["w_down"].float().numpy(),
        np.asarray(params["stack_moe"]["w_down"], np.float32))
    ours = TT.init_params(tcfg, 0, device="cpu")
    assert sorted(ours) == sorted(carried)
    for k, v in ours["stack_moe"].items():
        assert (v.shape, v.dtype) == (stack[k].shape, stack[k].dtype), k
    assert stack["router"].shape == (2, tcfg.d_model, tcfg.num_experts)
    assert stack["w_gate"].shape == (2, tcfg.num_experts, tcfg.d_model,
                                     tcfg.moe_d_ff)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e"])
def test_moe_stack_remat_on_and_off_give_the_same_bits(arch):
    """The aux terms leave each rematerialized layer with its output:
    the loss, the aux metrics and every gradient bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(7)))
    tok = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 97)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    out = []
    for remat in (True, False):
        tp = convert.params_from_jax(params, "cpu")
        leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
        loss, metrics = TT.loss_fn(tcfg, tp, batch, remat=remat)
        out.append((loss, metrics, torch.autograd.grad(loss, leaves)))
    (l1, m1, g1), (l2, m2, g2) = out
    assert torch.equal(l1, l2)
    assert {"load_balance", "router_z"} <= set(m1)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
