"""The port's inner optimizers against the reference: the batched,
sync-free Armijo search against the reference's while-loop, the rolling
Hessian sub-window offsets, and 10-step Newton-CG / GD trajectories."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.data.device_window import rolling_subwindow as j_subwindow
from repro.models import linear as jlin
from repro.optim import GradientDescent as JGD, NewtonCG as JNCG
from repro.optim.api import armijo_line_search as j_armijo
from repro_torch.data.device_window import rolling_subwindow as t_subwindow
from repro_torch.models import linear as tlin
from repro_torch.optim import GradientDescent as TGD, NewtonCG as TNCG
from repro_torch.optim.api import armijo_line_search as t_armijo

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

DS = jsyn.load("w8a_like", scale=0.05)          # n = 409, d = 300
X_NP, Y_NP = np.array(DS.X), np.array(DS.y)
J_DATA = (DS.X, DS.y)
T_DATA = (torch.from_numpy(X_NP), torch.from_numpy(Y_NP))


def _objectives(loss="squared_hinge", lam=1e-3):
    return jlin.make_objective(loss, lam=lam), tlin.make_objective(loss, lam=lam)


@pytest.mark.parametrize("scale,claim,expect_pass", [
    (-1.0, 1.0, True),     # descent along -g: passes at once or after a few halvings
    (-300.0, 1.0, True),   # a huge step: several halvings before Armijo holds
    # a slope claimed 1e9 times too steep: no α ≥ 2^-29 can keep up, so
    # none passes -> α = 0, f_new = f0, max_steps evaluations
    (-1.0, 1e9, False),
])
@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_batched_armijo_matches_reference_loop(scale, claim, expect_pass, loss):
    jobj, tobj = _objectives(loss)
    w = (0.05 * np.random.default_rng(0).standard_normal(DS.d)).astype(np.float32)
    f0, g = jax.value_and_grad(jobj)(jnp.asarray(w), J_DATA)
    ja, jf, jn = j_armijo(jobj, jnp.asarray(w), J_DATA, scale * g, claim * g,
                          f0=f0, max_steps=30)
    tw = torch.from_numpy(w)
    tf0, tg = tobj.value_and_grad(tw, T_DATA)
    ta, tf, tn = t_armijo(tobj, tw, T_DATA, scale * tg, claim * tg, f0=tf0,
                          max_steps=30)
    assert float(ta) == float(ja)                 # exact powers of two (or 0)
    assert int(tn) == int(jn)
    assert (float(ta) > 0) == expect_pass
    if expect_pass:
        np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
    else:
        assert float(tf) == float(tf0)


@pytest.mark.parametrize("n,fraction", [(409, 0.2), (128, 0.1), (7, 0.5),
                                        (1000, 1.0), (33, 0.01)])
def test_rolling_subwindow_offsets_equal(n, fraction):
    idx = np.arange(n, dtype=np.float32)
    for t in range(0, 12):
        (jsub,) = j_subwindow((jnp.asarray(idx),), fraction, jnp.int32(t))
        (tsub,) = t_subwindow((torch.from_numpy(idx),), fraction, t)
        assert np.array_equal(np.asarray(jsub), tsub.numpy()), (n, fraction, t)


@pytest.mark.parametrize("jopt,topt", [
    (JNCG(hessian_fraction=0.2), TNCG(hessian_fraction=0.2)),
    (JGD(), TGD()),
], ids=["newton_cg", "gd"])
def test_ten_step_trajectories_match(jopt, topt):
    jobj, tobj = _objectives()
    jstep = jax.jit(lambda p, s: jopt.step(p, s, jobj, J_DATA))
    jw, js = jlin.init_params(DS.d), jopt.init(jlin.init_params(DS.d))
    tw = tlin.init_params(DS.d, device="cpu")
    ts = topt.init(tw)
    for k in range(10):
        jw, js, jaux = jstep(jw, js)
        tw, ts, taux = topt.step(tw, ts, tobj, T_DATA)
        # float32 in different summation orders, compounded over the
        # steps of a strongly convex problem that contracts errors
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-3,
                                   atol=1e-5, err_msg=f"step {k}")
        np.testing.assert_allclose(float(taux["f"]), float(jaux["f"]),
                                   rtol=1e-5, err_msg=f"step {k}")
        assert float(taux["alpha"]) == float(jaux["alpha"]), k


def test_run_stacks_the_steps_of_step():
    _, tobj = _objectives()
    opt = TNCG(hessian_fraction=0.2)
    w0 = tlin.init_params(DS.d, device="cpu")
    w, s, fs = opt.run(w0, opt.init(w0), tobj, T_DATA, 3)
    w_ref, s_ref = w0, opt.init(w0)
    for k in range(3):
        w_ref, s_ref, aux = opt.step(w_ref, s_ref, tobj, T_DATA)
        assert float(fs[k]) == float(aux["f"])
    assert torch.equal(w, w_ref) and s == s_ref == {"t": 3}
    _, _, recs = opt.run(w0, opt.init(w0), tobj, T_DATA, 2,
                         collect=lambda p, aux: {"f": aux["f"], "w": p})
    assert recs["f"].shape == (2,) and recs["w"].shape == (2, DS.d)


def test_quadratic_exact_step_matches_reference():
    from repro.optim.api import quadratic_exact_step as j_quad
    from repro_torch.optim.api import quadratic_exact_step as t_quad
    jobj, tobj = _objectives("logistic")
    w = (0.05 * np.random.default_rng(4).standard_normal(DS.d)).astype(np.float32)
    _, g = jax.value_and_grad(jobj)(jnp.asarray(w), J_DATA)
    ja = j_quad(jobj, jnp.asarray(w), J_DATA, -g, g)
    tw = torch.from_numpy(w)
    _, tg = tobj.value_and_grad(tw, T_DATA)
    np.testing.assert_allclose(float(t_quad(tobj, tw, T_DATA, -tg, tg)),
                               float(ja), rtol=1e-4)
