"""Kernel B3 (the Mamba selective scan) of the port against the reference,
on the CPU: the plain version behind ``repro_torch.kernels.ops.ssm_scan``
against ``repro.kernels.ops.ssm_scan`` (the Pallas kernel in interpret
mode, as the reference's own tests run it), forward on the sweep of
``tests/test_kernels.py`` and backward in all six arguments through the
port's ``torch.autograd.Function``; then ``mamba_block`` on the reduced
falcon-mamba-7b with the reference's parameters carried across."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import mamba as jmamba
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tss
from repro_torch.models import mamba as tmamba

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# the reference's own bounds (tests/test_kernels.py): f32 1e-4, bf16 5e-2
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(B, S, di, N, seed):
    """u, delta, B, C, A_log, D as float32 numpy, the reference test's
    distributions."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    Bs = rng.standard_normal((B, S, N)).astype(np.float32)
    Cs = rng.standard_normal((B, S, N)).astype(np.float32)
    Al = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32)[None],
                        (di, 1)))
    D = np.ones((di,), np.float32)
    return [u, dt, Bs, Cs, Al, D]


def _both(arrays, dtype):
    """The same inputs for each package; u, delta, B, C in ``dtype``
    (both round float32 to bfloat16 to nearest even), A_log, D float32."""
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    for i in range(4):
        j[i] = j[i].astype(jnp.dtype(dtype))
        t[i] = t[i].to(getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("B,S,di,N", [(1, 32, 64, 4), (2, 64, 128, 16),
                                      (1, 100, 96, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssm_scan_matches_reference(B, S, di, N, dtype):
    j, t = _both(_inputs(B, S, di, N, seed=B * S + di + N), dtype)
    want = jops.ssm_scan(*j, block_d=32)
    got = tops.ssm_scan(*t)
    assert got.dtype == t[0].dtype and got.shape == (B, S, di)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_ssm_scan_state_decay():
    """With large delta·|A| the state forgets: the output at t is dominated
    by recent inputs (the reference's recurrence stability check)."""
    B, S, di, N = 1, 64, 32, 4
    u = torch.zeros((B, S, di))
    u[:, 0, :] = 100.0                                  # impulse at t=0
    y = tops.ssm_scan(u, torch.full((B, S, di), 2.0), torch.ones((B, S, N)),
                      torch.ones((B, S, N)), torch.zeros((di, N)),
                      torch.zeros((di,)))
    assert float(y[0, 0].abs().max()) > float(y[0, -1].abs().max()) * 100
    j = [jnp.asarray(x.numpy()) for x in (u, torch.full((B, S, di), 2.0),
                                          torch.ones((B, S, N)),
                                          torch.ones((B, S, N)),
                                          torch.zeros((di, N)),
                                          torch.zeros((di,)))]
    np.testing.assert_allclose(y.numpy(), np.asarray(jops.ssm_scan(
        *j, block_d=32)), rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _grads(B, S, di, N):
    """d/d(all six args) of sum(y), through the reference's custom_vjp
    (one jax.grad) and the port's autograd.Function (one backward),
    computed once per shape for the six cases that read them."""
    arrays = _inputs(B, S, di, N, seed=7)
    arrays[5] = np.full((di,), 0.5, np.float32)
    j, t = _both(arrays, "float32")
    want = jax.grad(lambda *a: jops.ssm_scan(*a, block_d=32).sum(),
                    argnums=tuple(range(6)))(*j)
    t = [x.requires_grad_(True) for x in t]
    tops.ssm_scan(*t).sum().backward()
    return [x.grad for x in t], [np.asarray(g) for g in want], t


@pytest.mark.parametrize("B,S,di,N", [(1, 32, 64, 4), (2, 48, 96, 8)])
@pytest.mark.parametrize("wrt", [0, 1, 2, 3, 4, 5])
def test_ssm_scan_grad_matches_reference(B, S, di, N, wrt):
    """d/d(arg) of sum(y) through the port's autograd.Function against
    jax.grad through the reference's custom_vjp, at the reference's 1e-4."""
    got, want, inputs = _grads(B, S, di, N)
    g = got[wrt]
    assert g.shape == inputs[wrt].shape and g.dtype == inputs[wrt].dtype
    np.testing.assert_allclose(g.numpy(), want[wrt], rtol=1e-4, atol=1e-4)


def test_ssm_scan_grad_is_the_plain_versions():
    """The backward pass is the VJP of the plain version, recomputed from
    the saved inputs: equal to autograd straight through it."""
    t = [torch.from_numpy(a) for a in _inputs(2, 20, 24, 4, seed=3)]
    a = [x.clone().requires_grad_(True) for x in t]
    b = [x.clone().requires_grad_(True) for x in t]
    g = torch.randn((2, 20, 24), generator=torch.Generator().manual_seed(0))
    tops.ssm_scan(*a).backward(g)
    tref.ssm_scan(*b).backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


def test_ssm_scan_refuses_other_devices():
    """The wrapper serves 'cpu' with the plain version and 'cuda' with the
    kernel, nothing else; the kernel wrapper itself takes CUDA tensors
    only, and a CPU run launches nothing."""
    meta = [torch.empty((1, 4, 8), device="meta")] * 2 + \
        [torch.empty((1, 4, 2), device="meta")] * 2 + \
        [torch.empty((8, 2), device="meta"), torch.empty((8,), device="meta")]
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tops.ssm_scan(*meta)
    cpu = [torch.from_numpy(a) for a in _inputs(1, 4, 8, 2, seed=0)]
    with pytest.raises(ValueError, match="CUDA device"):
        tss.ssm_scan(*cpu)
    tops.reset_calls()
    tops.ssm_scan(*cpu)
    assert tops.CALLS["ssm_scan"] == 0


@pytest.fixture(scope="module")
def reduced_mamba():
    """reduced(falcon-mamba-7b) in float32 and the reference's parameters
    (its own init), exported as numpy."""
    jcfg = jconfigs.reduced(jconfigs.get("falcon-mamba-7b")).with_(
        dtype=jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get("falcon-mamba-7b")).with_(
        dtype=torch.float32)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, params


def test_reduced_config_matches_reference(reduced_mamba):
    jcfg, tcfg, _ = reduced_mamba
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mamba_block_matches_reference(reduced_mamba, impl):
    """One layer of the reduced model, float32, through the kernel route
    ("pallas": the Pallas kernel in interpret mode vs the port's plain
    version) and the scan route.  Bound 1e-4: the same float32 algorithm
    summed in other orders, as the scan's own bound."""
    jcfg, tcfg, params = reduced_mamba
    p = {k: v[0] for k, v in params["stack_ssm"].items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    want = jmamba.mamba_block(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), impl=impl)
    got = tmamba.mamba_block(tcfg, convert.params_from_jax(p, device="cpu"),
                             torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
