"""Kernel B4 (the RG-LRU recurrence) of the port against the reference, on
the CPU: the plain version behind ``repro_torch.kernels.ops.rglru_scan``
against ``repro.kernels.ops.rglru_scan`` (the Pallas kernel in interpret
mode, as the reference's own tests run it), forward on the sweep of
``tests/test_kernels.py`` and backward in a and b through the port's
``torch.autograd.Function``; then ``rg_lru`` and ``recurrent_block`` on
the reduced recurrentgemma-9b with the reference's parameters carried
across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.models import rglru as trglru

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# the reference's own bounds (tests/test_kernels.py): f32 1e-5, bf16 5e-2
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(B, S, W, seed):
    """a = sigmoid(normal) in (0, 1), b normal: the reference test's
    distributions, as float32 numpy."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    b = rng.standard_normal((B, S, W))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("B,S,W", [(1, 32, 64), (2, 100, 96), (1, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rglru_scan_matches_reference(B, S, W, dtype):
    a, b = _inputs(B, S, W, seed=B * S + W)
    want = jops.rglru_scan(jnp.asarray(a).astype(dtype),
                           jnp.asarray(b).astype(dtype), block_w=32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    got = tops.rglru_scan(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (B, S, W)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_rglru_scan_is_the_linear_recurrence():
    """a = 1 accumulates b; a = 0 forgets everything but b_t."""
    b = torch.arange(12, dtype=torch.float32).reshape(1, 4, 3)
    np.testing.assert_array_equal(
        tops.rglru_scan(torch.ones_like(b), b).numpy(),
        torch.cumsum(b, dim=1).numpy())
    np.testing.assert_array_equal(
        tops.rglru_scan(torch.zeros_like(b), b).numpy(), b.numpy())


@pytest.mark.parametrize("B,S,W", [(1, 32, 64), (2, 48, 96)])
@pytest.mark.parametrize("wrt", [0, 1])
def test_rglru_scan_grad_matches_reference(B, S, W, wrt):
    """The backward pass (the plain version's VJP, recomputed from the
    saved inputs) against jax.grad of the Pallas path, at the reference's
    1e-4."""
    a, b = _inputs(B, S, W, seed=7 + S)
    want = jax.grad(lambda a, b: jops.rglru_scan(a, b, block_w=32).sum(),
                    argnums=wrt)(jnp.asarray(a), jnp.asarray(b))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (a, b)]
    tops.rglru_scan(*t).sum().backward()
    got = t[wrt].grad
    assert got.shape == (B, S, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert t[1 - wrt].grad is not None


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing_there():
    a, b = (torch.from_numpy(x) for x in _inputs(1, 8, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA device"):
        trg.rglru_scan(a, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trg.rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="one shape"):
        trg.rglru_scan(a, b[:, :4])
    tops.reset_calls()
    tops.rglru_scan(a, b)
    assert tops.CALLS["rglru_scan"] == 0
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tops.rglru_scan(a.to("meta"), b.to("meta"))


def test_plain_version_in_float64_matches_float32():
    """The card's accuracy check runs the plain version in float64; that
    carries h in float64 and agrees with the float32 carry."""
    a, b = (torch.from_numpy(x) for x in _inputs(2, 64, 32, seed=3))
    np.testing.assert_allclose(tref.rglru_scan(a.double(), b.double()),
                               tref.rglru_scan(a, b).double(), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ model pieces
@pytest.fixture(scope="module")
def rec_layer():
    """The reduced recurrentgemma-9b in float32 and the first ``rec``
    layer of the reference's parameters, in both packages."""
    jcfg = jconfigs.reduced(jconfigs.get("recurrentgemma-9b")).with_(
        dtype=jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get("recurrentgemma-9b")).with_(
        dtype=torch.float32)
    params = jax.device_get(JT.init_params(jcfg, jax.random.key(0)))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["stack_rec"])
    return jcfg, tcfg, jp, convert.params_from_jax(jp, "cpu")


def _x(B, S, d, seed, scale=1.0):
    x = scale * np.random.default_rng(seed).standard_normal((B, S, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_rg_lru_matches_reference(rec_layer, impl):
    """Both routes of ``rg_lru``: the trajectory and h_final within 1e-5
    (float32; the reference's ``impl="pallas"`` takes h_final from the
    cast trajectory, its ``impl="xla"`` from the float32 carry)."""
    _, tcfg, jp, tp = rec_layer
    x = _x(2, 40, tcfg.lru_width, seed=1)
    jy, jh = jrglru.rg_lru(jp, jnp.asarray(x), impl=impl)
    ty, th = trglru.rg_lru(tp, torch.from_numpy(x), impl=impl)
    assert th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def test_rg_lru_casts_the_scan_inputs_to_x_dtype():
    """On the kernel route the reference casts a and the gated input to
    x's dtype before the scan, and h_final comes from the cast output:
    in bfloat16 h_final is exactly the last row of y, widened, in both
    packages, and both agree within the bfloat16 bound."""
    w = tconfigs.reduced(tconfigs.get("recurrentgemma-9b")).lru_width
    rng = np.random.default_rng(5)
    p = {"w_a": (0.1 * rng.standard_normal((w, w))).astype(np.float32),
         "w_x": (0.1 * rng.standard_normal((w, w))).astype(np.float32),
         "lambda_p": np.full((w,), 0.5, np.float32)}
    x = rng.standard_normal((1, 16, w)).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16 if k != "lambda_p"
                                   else jnp.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k != "lambda_p"
                                    else torch.float32) for k, v in p.items()}
    jy, jh = jrglru.rg_lru(jp, jnp.asarray(x).astype(jnp.bfloat16),
                           impl="pallas")
    y, h = trglru.rg_lru(tp, torch.from_numpy(x).to(torch.bfloat16),
                         impl="pallas")
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(h, y[:, -1, :].float())
    np.testing.assert_array_equal(np.asarray(jh),
                                  np.asarray(jy[:, -1, :], np.float32))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_recurrent_block_matches_reference(rec_layer, impl):
    """The Griffin block (two projections, conv, RG-LRU, gelu gate, out
    projection) at reduced width, float32, within 1e-5."""
    jcfg, tcfg, jp, tp = rec_layer
    x = _x(2, 32, tcfg.d_model, seed=2)
    want = jrglru.recurrent_block(jcfg, jp, jnp.asarray(x), impl=impl)
    got = trglru.recurrent_block(tcfg, tp, torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_recurrent_block_gelu_is_the_tanh_approximation(rec_layer,
                                                        monkeypatch):
    """With inputs scaled so the gate's pre-activations reach |z| ~ 3,
    exact (erf) gelu differs from the tanh approximation by ~1e-3 there:
    the block agrees with the reference at 1e-5 only with the tanh form."""
    jcfg, tcfg, jp, tp = rec_layer
    x = _x(1, 16, tcfg.d_model, seed=3, scale=3.0)
    want = np.asarray(jrglru.recurrent_block(jcfg, jp, jnp.asarray(x),
                                             impl="pallas"))
    got = trglru.recurrent_block(tcfg, tp, torch.from_numpy(x),
                                 impl="pallas").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    gelu = torch.nn.functional.gelu
    monkeypatch.setattr(trglru.F, "gelu",
                        lambda z, approximate="none": gelu(z))
    erf_out = trglru.recurrent_block(tcfg, tp, torch.from_numpy(x),
                                     impl="pallas").numpy()
    assert np.abs(erf_out - want).max() > 100 * 1e-5


def test_reference_oracle_and_port_plain_version_agree_in_float64():
    """The port's plain version and the reference's oracle are the same
    recurrence (float64 on the port's side, float32 carry on JAX's)."""
    a, b = _inputs(1, 50, 8, seed=4)
    want = jref.rglru_scan(jnp.asarray(a), jnp.asarray(b))
    got = tref.rglru_scan(torch.from_numpy(a).double(),
                          torch.from_numpy(b).double())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
