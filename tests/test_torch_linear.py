"""The port's convex problem against the reference: ``data/synthetic.py``
(bit-identical arrays) and ``models/linear.py`` (objective, closed-form
gradient and HVP against JAX autodiff, accuracy, RFVD)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.models import linear as jlin
from repro.optim.api import hessian_vector_product
from repro_torch.data import synthetic as tsyn
from repro_torch.models import linear as tlin

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# float32 sums over at most ~600 rows, taken in different orders by XLA
# and by PyTorch: agreement to a few ulps of the result's scale
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("name", sorted(jsyn.PAPER_LIKE))
def test_make_classification_bit_identical(name):
    scale = 64 / jsyn.PAPER_LIKE[name]["n"]     # the generator's floor, n=64
    ref = jsyn.load(name, seed=3, scale=scale)
    port = tsyn.load(name, seed=3, scale=scale, device="cpu")
    for field in ("X", "y", "X_test", "y_test"):
        a, b = np.asarray(getattr(ref, field)), getattr(port, field).numpy()
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b), field
    assert (port.n, port.d) == (ref.n, ref.d)


def test_window_is_a_view():
    ds = tsyn.load("w8a_like", scale=0.01, device="cpu")
    X, y = ds.window(40)
    assert X._base is ds.X and y._base is ds.y
    assert X.shape == (40, ds.d) and y.shape == (40,)


def _problem(loss, seed=0, n=600, d=300):
    rng = np.random.default_rng(seed)
    ds = jsyn.make_classification("w8a_like", n=n, d=d, seed=seed)
    X, y = np.array(ds.X), np.array(ds.y)
    # margins on both sides of 1, none at the hinge's kink
    w = (0.5 * rng.standard_normal(d)).astype(np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    return X, y, w, v


@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_objective_value_grad_hvp_match_autodiff(loss):
    lam = 1e-3
    X, y, w, v = _problem(loss)
    jobj = jlin.make_objective(loss, lam=lam)
    jdata = (jnp.asarray(X), jnp.asarray(y))
    jf, jg = jax.value_and_grad(jobj)(jnp.asarray(w), jdata)
    jhv = hessian_vector_product(jobj, jnp.asarray(w), jdata, jnp.asarray(v))

    tobj = tlin.make_objective(loss, lam=lam)
    tdata = (torch.from_numpy(X), torch.from_numpy(y))
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    tf, tg = tobj.value_and_grad(tw, tdata)
    np.testing.assert_allclose(float(tobj(tw, tdata)), float(jf), rtol=RTOL)
    np.testing.assert_allclose(float(tf), float(jf), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(tobj.hvp(tw, tdata, tv).numpy(), np.asarray(jhv),
                               rtol=1e-4, atol=ATOL)
    # batched values (the Armijo search's one GEMM) agree with single evals
    W = torch.stack([tw, 0.5 * tw, tv], dim=1)
    vals = tobj.values(W, tdata)
    for k in range(3):
        np.testing.assert_allclose(float(vals[k]), float(tobj(W[:, k], tdata)),
                                   rtol=RTOL)


def test_accuracy_and_rfvd_match():
    X, y, w, _ = _problem("squared_hinge", seed=1)
    jobj = jlin.make_objective("squared_hinge", lam=1e-3)
    tobj = tlin.make_objective("squared_hinge", lam=1e-3)
    jdata = (jnp.asarray(X), jnp.asarray(y))
    tdata = (torch.from_numpy(X), torch.from_numpy(y))
    tw = torch.from_numpy(w)
    acc_t = float(tlin.accuracy(tw, *tdata))
    acc_j = float(jlin.accuracy(jnp.asarray(w), *jdata))
    # the same count of hits; XLA's mean rounds the division one ulp apart
    assert round(acc_t * len(y)) == round(acc_j * len(y))
    np.testing.assert_allclose(acc_t, acc_j, rtol=1e-6)
    f_star = 0.9 * float(jobj(jnp.asarray(w), jdata))
    np.testing.assert_allclose(
        float(tlin.rfvd(tobj, tw, tdata, torch.tensor(f_star))),
        float(jlin.rfvd(jobj, jnp.asarray(w), jdata, jnp.float32(f_star))),
        rtol=1e-4)


def test_solve_reference_matches():
    X, y, _, _ = _problem("logistic", seed=2, n=256, d=32)
    jobj = jlin.make_objective("logistic", lam=1e-2)
    tobj = tlin.make_objective("logistic", lam=1e-2)
    _, jf = jlin.solve_reference(jobj, jlin.init_params(32),
                                 (jnp.asarray(X), jnp.asarray(y)), steps=5)
    _, tf = tlin.solve_reference(tobj, tlin.init_params(32, device="cpu"),
                                 (torch.from_numpy(X), torch.from_numpy(y)),
                                 steps=5)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
