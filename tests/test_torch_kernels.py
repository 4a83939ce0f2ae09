"""The port's B1 wrapper (``repro_torch.kernels.ops.linear_value_grad``)
against the reference's Pallas kernel, run as the reference's own tests
run it on the CPU (``repro.kernels.ops`` with ``INTERPRET=True``).

On the CPU the port's wrapper dispatches to the plain PyTorch version; the
CUDA kernel itself is checked on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, linear_grad, ops, ref

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# the reference kernel's own bound against its oracle (tests/test_kernels.py:25):
# float32 sums taken in different orders by the two implementations
RTOL, ATOL = 1e-4, 1e-3


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    y[y == 0] = 1.0
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("n,d", [(128, 16), (256, 300), (384, 64), (200, 32)])
@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_linear_value_grad_matches_reference_kernel(n, d, loss):
    assert jops.INTERPRET
    X, y, w = _inputs(n, d, seed=n * 1000 + d)
    Lj, gj = jops.linear_value_grad(jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(w), loss=loss)
    Lt, gt = ops.linear_value_grad(torch.from_numpy(X), torch.from_numpy(y),
                                   torch.from_numpy(w), loss=loss)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_plain_version_matches_autograd(loss):
    X, y, w = (torch.from_numpy(a) for a in _inputs(256, 40, seed=7))
    _, g = ref.linear_value_grad(X, y, w, loss=loss)
    wr = w.clone().requires_grad_(True)
    m = y * (X @ wr)
    li = (torch.clamp(1 - m, min=0) ** 2 if loss == "squared_hinge"
          else torch.nn.functional.softplus(-m))
    li.sum().backward()
    # same float32 expression, one summation order apart
    np.testing.assert_allclose(g.numpy(), wr.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_is_the_plain_version_and_uncounted():
    ops.reset_calls()
    X, y, w = (torch.from_numpy(a) for a in _inputs(200, 32, seed=3))
    L, g = ops.linear_value_grad(X, y, w)
    Lr, gr = ref.linear_value_grad(X, y, w)
    assert torch.equal(L, Lr) and torch.equal(g, gr)
    assert ops.CALLS["linear_value_grad"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    X, y, w = (torch.from_numpy(a) for a in _inputs(64, 8, seed=1))
    # the CUDA wrapper never takes CPU tensors (the check runs before any
    # build, so this holds without a card)
    with pytest.raises(ValueError, match="CUDA device"):
        linear_grad.linear_value_grad(X, y, w)
    with pytest.raises(ValueError, match="shape mismatch"):
        linear_grad.linear_value_grad(X, y[:10], w)
    with pytest.raises(ValueError, match="unknown loss"):
        linear_grad.linear_value_grad(X, y, w, loss="hinge")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ops.linear_value_grad(X.to("meta"), y.to("meta"), w.to("meta"))


def test_build_target_names_source_and_flags():
    path = build.target("linear_grad")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("liblinear_grad_") and path.suffix == ".so"
    assert path == build.target("linear_grad")       # stable across calls
    assert "arch=compute_90a,code=sm_90a" in " ".join(build.FLAGS)

