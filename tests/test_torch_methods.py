"""The paper's method set on the port against the reference, on the CPU:
10-step trajectories of the other inner optimizers (nonlinear CG with the
exact and the Armijo search, L-BFGS, Adagrad, AdamW), ``variance_stats``,
the ``GradientVariance`` policy alone and as a veto of ``two_track``,
``run_dsm`` and ``run_minibatch``, and the ``run_method`` set of the
reference's benchmarks through ``repro_torch.launch.methods``; then the
registries, ``optimizer_spec_of``, the closed forms and the examples."""
import contextlib
import io
import runpy
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro.core as JC
import repro.optim as JO
import repro_torch.api as P
import repro_torch.core as TC
import repro_torch.optim as TO
from repro.core import engine as jengine
from repro.data import synthetic as jsyn
from repro.models import linear as jlin
from repro_torch.core import engine as tengine
from repro_torch.kernels import ops as tops
from repro_torch.launch import methods as tmethods
from repro_torch.models import linear as tlin

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSSES = ["squared_hinge", "logistic"]
COLUMNS = ("step", "stage", "window", "time", "accesses")
# float32 in other summation orders: ten steps of each optimizer stay
# within 1.1e-5 of the trajectory's largest entry and 1.4e-6 relative on
# f̂ (measured); 1e-4 is the bound
RTOL = 1e-4
# f̂ over whole runs (dozens of steps and their discrete choices: Armijo
# step lengths, variance tests), the engine tests' bounds
RTOL_F, ATOL_F = 1e-4, 1e-3

DS = jsyn.load("w8a_like", scale=0.05)          # n = 409, d = 300
J_DATA = (DS.X, DS.y)
T_DATA = (torch.from_numpy(np.array(DS.X)), torch.from_numpy(np.array(DS.y)))


def _objectives(loss):
    return (jlin.make_objective(loss, lam=1e-3),
            tlin.make_objective(loss, lam=1e-3))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("name,params", [
    ("cg", {}), ("cg", {"exact_line_search": False}), ("lbfgs", {}),
    ("lbfgs", {"history": 3}), ("adagrad", {"lr": 0.5}),
    ("adamw", {"lr": 0.05}),
], ids=["cg_exact", "cg_armijo", "lbfgs", "lbfgs_ring_wraps", "adagrad",
        "adamw"])
def test_ten_step_trajectories_match(name, params, loss):
    jobj, tobj = _objectives(loss)
    jopt, topt = JO.REGISTRY[name](**params), TO.REGISTRY[name](**params)
    jstep = jax.jit(lambda p, s: jopt.step(p, s, jobj, J_DATA))
    jw = jlin.init_params(DS.d)
    js = jopt.init(jw)
    tw = tlin.init_params(DS.d, device="cpu")
    ts = topt.init(tw)
    for k in range(10):
        jw, js, jaux = jstep(jw, js)
        tw, ts, taux = topt.step(tw, ts, tobj, T_DATA)
        want = np.asarray(jw)
        np.testing.assert_allclose(tw.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(),
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(float(taux["f"]), float(jaux["f"]),
                                   rtol=RTOL, err_msg=f"step {k}")


def test_lbfgs_ring_keeps_the_newest_pairs_on_the_device():
    """After more steps than the history holds, ``count`` keeps counting
    and the ring holds the last ``history`` pairs; a reset empties it."""
    _, tobj = _objectives("squared_hinge")
    opt = TO.LBFGS(history=3)
    w = tlin.init_params(DS.d, device="cpu")
    st = opt.init(w)
    for _ in range(6):
        w, st, _ = opt.step(w, st, tobj, T_DATA)
    assert st["count"].dtype == torch.int64 and int(st["count"]) == 5
    assert bool((st["rho"] > 0).all())
    st = opt.reset_memory(st)
    assert int(st["count"]) == 0 and not bool(st["have_prev"])
    assert not bool(st["s"].any())


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("k", [1, 64, 409])
def test_variance_stats_match_reference(loss, k):
    jobj, tobj = _objectives(loss)
    w = (0.1 * np.random.default_rng(k).standard_normal(DS.d)) \
        .astype(np.float32)
    jv, jg2 = jengine.variance_stats(jobj, jnp.asarray(w), J_DATA, k)
    tv, tg2 = tengine.variance_stats(tobj, torch.from_numpy(w), T_DATA, k)
    np.testing.assert_allclose(float(tg2), float(jg2), rtol=RTOL)
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL,
                               atol=RTOL * float(jg2) if k == 1 else 0.0)


def _spec(policy, params, *, veto=(), optimizer="newton_cg"):
    """w8a_like at 1,024 x 300 from a first window of 128: the windows the
    reference's run_method starts from (n0 near d), where Newton-CG's
    sub-sampled Hessian (20 % of the window) is not degenerate."""
    opt_params = {"hessian_fraction": 0.2} if optimizer == "newton_cg" else {}
    return R.RunSpec(
        data=R.DataSpec(dataset="w8a_like", scale=0.125, lam=1e-3),
        policy=R.PolicySpec(policy, params, veto=veto),
        optimizer=R.OptimizerSpec(optimizer, opt_params),
        schedule=R.ScheduleSpec(n0=128, clock={"p": 10.0, "a": 1.0,
                                               "s": 5.0}))


def _float64_cg_direction(X, y, w, t, loss, *, lam=1e-3, fraction=0.2,
                          cg_steps=10):
    """Newton-CG's direction at ``w`` in float64 numpy, written out apart
    from both packages: ``cg_steps`` of linear CG on the curvature of the
    rolling ``fraction`` sub-window at step ``t``."""
    X, y, w = (np.asarray(a, np.float64) for a in (X, y, w))
    n = len(y)
    m = y * (X @ w)
    if loss == "logistic":
        dl = -1.0 / (1.0 + np.exp(m))                   # ℓ′, ℓ = softplus(−m)
    else:
        dl = -2.0 * np.maximum(0.0, 1.0 - m)
    g = X.T @ (dl * y) / n + lam * w
    k = max(1, round(fraction * n))
    off = (t * k) % (n - k + 1)
    Xs, ms = X[off:off + k], m[off:off + k]
    curv = (1.0 / (1.0 + np.exp(-ms)) / (1.0 + np.exp(ms))
            if loss == "logistic" else 2.0 * (ms < 1.0))
    d, r, p = np.zeros_like(w), g.copy(), -g
    rs = r @ r
    for _ in range(cg_steps):
        hp = Xs.T @ (curv * (Xs @ p)) / k + lam * p
        a = rs / (p @ hp)
        d, r = d + a * p, r + a * hp
        rs, rs_old = r @ r, rs
        p = -r + rs / rs_old * p
    return d


@pytest.mark.parametrize("loss", LOSSES)
def test_newton_cg_gap_on_a_small_window_is_float32_rounding(loss):
    """The fixture below: Newton-CG on a 128-row window with a 26-row
    Hessian sample, at the reference's first four points.  The port's
    direction in float64 is an independent float64 CG's, within 1e-9 or a
    hundred times what a 1e-15 relative change of X moves that CG's own
    direction.  With the logistic loss that change moves it by more than
    1e-7 at the second point (ten CG steps on the rank-26 curvature
    amplify the rounding by ~1e10), and there the reference's own float32
    direction parts from the float64 one by more than 1e-4; with the
    squared hinge it stays within 1e-4.  Hence the GradientVariance runs
    below hold the squared hinge to the reference."""
    jobj, tobj = _objectives(loss)
    X, y = np.array(DS.X[:128]), np.array(DS.y[:128])
    shaken = X * (1 + 1e-15 * np.random.default_rng(0)
                  .standard_normal(X.shape))
    jopt = JO.NewtonCG(hessian_fraction=0.2)
    topt = TO.NewtonCG(hessian_fraction=0.2)
    jstep = jax.jit(lambda w, s: jopt.step(w, s, jobj, (X, y)))
    X64, y64 = torch.from_numpy(X).double(), torch.from_numpy(y).double()
    w = np.zeros(DS.d, np.float32)
    spread, ref_gap = [], []
    for t in range(4):
        exact = _float64_cg_direction(X, y, w, t, loss)
        scale = np.abs(exact).max()
        spread.append(np.abs(_float64_cg_direction(shaken, y, w, t, loss)
                             - exact).max() / scale)
        w64 = torch.from_numpy(w.copy()).double()
        new, _, aux = topt.step(w64, {"t": t}, tobj, (X64, y64))
        port = ((new - w64) / aux["alpha"]).numpy()
        np.testing.assert_allclose(
            port, exact, rtol=0, atol=(1e-9 + 100 * spread[-1]) * scale,
            err_msg=f"step {t}")
        jw, _, jaux = jstep(jnp.asarray(w), {"t": jnp.int32(t)})
        jw = np.array(jw)
        ref = (jw.astype(np.float64) - w) / float(jaux["alpha"])
        ref_gap.append(np.abs(ref - exact).max() / scale)
        w = jw
    if loss == "logistic":
        assert spread[1] > 1e-7 and ref_gap[1] > RTOL, (spread, ref_gap)
    else:
        assert max(ref_gap) < RTOL, ref_gap


def _both(spec):
    ref_sess = R.build(spec)
    ref = ref_sess.run()
    sess = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
    rounds = []
    race = sess.engine._race

    def counting(*a, **kw):                 # steps of each race round
        out = race(*a, **kw)
        rounds.append(out[2]["hist"].shape[1])
        return out

    sess.engine._race = counting
    return ref_sess, ref, sess, sess.run(), rounds


def _assert_same_run(ref_sess, ref, sess, port):
    assert len(port.points) == len(ref.points)
    for col in COLUMNS:
        assert port.column(col) == ref.column(col), col
    assert sess.clock.snapshot() == ref_sess.clock.snapshot()  # loaded too
    np.testing.assert_allclose(port.column("f_full"), ref.column("f_full"),
                               rtol=RTOL_F, atol=ATOL_F)
    assert port.meta["stages"] == ref.meta["stages"]


def _race_chunks(s):
    """Pulls of a race round of s steps: chunks end at 2, 4, 8, ..."""
    end = 2
    while end < s:
        end *= 2
    return end.bit_length() - 1


def test_gradient_variance_matches_reference():
    """The scan stages pull the variance statistics with the chunk's
    records: one transfer per chunk, as the reference.  At θ = 2 the test
    holds stages for several chunks: one ends on it, others at
    ``max_stage_iters``."""
    spec = _spec("gradient_variance", {"theta": 2.0, "final_steps": 6})
    ref_sess, ref, sess, port, _ = _both(spec)
    _assert_same_run(ref_sess, ref, sess, port)
    stages = port.column("stage")
    lengths = [stages.count(s) for s in sorted(set(stages))]
    assert len(lengths) > 2 and any(4 < n < 64 for n in lengths[:-1])
    assert port.meta["host_transfers"] == ref.meta["host_transfers"]


def test_gradient_variance_veto_of_two_track_matches_reference():
    """A racing stage ends when condition (3) fires and the variance test
    concurs; each race round is followed by one pull of the variance
    statistics, as in the reference, whose race itself pulls once a round
    where the port's pulls once a chunk (cumulative sizes 2, 4, 8, ...)."""
    spec = _spec("two_track", {"final_steps": 6},
                 veto=(R.PolicySpec("gradient_variance", {"theta": 1.0}),))
    ref_sess, ref, sess, port, rounds = _both(spec)
    _assert_same_run(ref_sess, ref, sess, port)
    assert len(rounds) > port.meta["stages"] - 1     # the veto held stages
    assert isinstance(sess.policy, tengine.ComposedPolicy)
    assert sess.policy.wants_variance and sess.policy.probe == 256
    assert sum(rounds) == sum("f_fast_on_t" in p.extra for p in port.points)
    # the reference: two pulls a round, one for the final phase
    assert ref.meta["host_transfers"] == 2 * len(rounds) + 1
    assert port.meta["host_transfers"] == \
        sum(_race_chunks(s) + 1 for s in rounds) + 1


def test_composed_policy_takes_variance_from_any_member():
    gv = tengine.GradientVariance(probe=64)
    composed = tengine.ComposedPolicy(tengine.TwoTrack(), vetoes=[gv])
    assert composed.wants_variance and composed.probe == 64
    plain = tengine.ComposedPolicy(tengine.FixedSteps(),
                                   any_of=[tengine.NeverExpand()])
    assert not plain.wants_variance and plain.probe == 0


def _problems(loss):
    d = R.DataSpec(dataset="w8a_like", scale=0.125, lam=1e-3, loss=loss)
    return (R.convex_problem(d),
            P.convex_problem(P.DataSpec.from_dict(d.to_dict()), device="cpu"))


def _assert_same_trace(ref, port):
    for col in COLUMNS:
        assert port.column(col) == ref.column(col), col
    np.testing.assert_allclose(port.column("f_full"), ref.column("f_full"),
                               rtol=RTOL_F, atol=ATOL_F)


@pytest.mark.parametrize("loss", LOSSES)
def test_run_dsm_matches_reference(loss):
    """The same samples (the host generator in the reference's order), the
    same growing sample sizes and clock; one pull per iteration."""
    (jds, jobj, jw0), (tds, tobj, tw0) = _problems(loss)
    frac = 2.0 * jds.d / jds.n
    clocks = JC.SimulatedClock(), TC.SimulatedClock()
    ref = JC.run_dsm(jds, JO.NewtonCG(hessian_fraction=frac), jobj,
                     theta=0.2, n0=128, steps=10, clock=clocks[0], w0=jw0)
    port = TC.run_dsm(tds, TO.NewtonCG(hessian_fraction=frac), tobj,
                      theta=0.2, n0=128, steps=10, clock=clocks[1], w0=tw0)
    _assert_same_trace(ref, port)
    assert clocks[1].snapshot() == clocks[0].snapshot()    # loaded too
    assert len(set(port.column("window"))) > 2
    for key in ("var", "g2"):
        np.testing.assert_allclose([p.extra[key] for p in port.points],
                                   [p.extra[key] for p in ref.points],
                                   rtol=RTOL_F)
    assert port.meta["host_transfers"] == 10


@pytest.mark.parametrize("loss", LOSSES)
def test_run_minibatch_matches_reference(loss, monkeypatch):
    """Adagrad on 64-row batches: one pull per recorded point, one kernel
    wrapper call per step."""
    (jds, jobj, jw0), (tds, tobj, tw0) = _problems(loss)
    clocks = JC.SimulatedClock(), TC.SimulatedClock()
    ref = JC.run_minibatch(jds, JO.Adagrad(lr=0.5), jobj, batch_size=64,
                           steps=90, clock=clocks[0], w0=jw0,
                           record_every=20)
    calls = []
    real = tops.linear_value_grad
    monkeypatch.setattr(tops, "linear_value_grad",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or real(*a, **kw))
    port = TC.run_minibatch(tds, TO.Adagrad(lr=0.5), tobj, batch_size=64,
                            steps=90, clock=clocks[1], w0=tw0,
                            record_every=20)
    _assert_same_trace(ref, port)
    assert clocks[1].snapshot() == clocks[0].snapshot()
    assert port.column("step") == [0, 20, 40, 60, 80, 89]
    assert port.meta["host_transfers"] == len(port.points)
    assert calls == [(64, tds.d)] * 90


def test_run_method_set_matches_reference():
    """benchmarks/common.py's run_method set (the reference) and the port's
    copy in repro_torch.launch.methods, on one small fixture."""
    from benchmarks import common as jcommon
    jds, jobj, jw0, jf = jcommon.setup("w8a_like", scale=0.125)
    tds, tobj, tw0, tf = tmethods.setup("w8a_like", scale=0.125,
                                        device="cpu")
    np.testing.assert_allclose(tf, jf, rtol=1e-5)
    kw = dict(steps=8, inner_steps=3, final_steps=6)
    for method in tmethods.METHODS:
        ref = jcommon.run_method(method, jds, jobj, jw0, **kw)
        port = tmethods.run_method(method, tds, tobj, tw0, **kw)
        _assert_same_trace(ref, port)
        assert jcommon.time_to_rfvd(ref, jf, 0.5) == \
            tmethods.time_to_rfvd(port, tf, 0.5), method
    row = tmethods.measure("batch", tds, tobj, tw0, tf, steps=3)
    assert row["steps"] == 3 and row["linear_value_grad_launches"] == 0
    assert np.isfinite(row["log_rfvd"]) and row["sim_time"] > 0


def test_every_registered_name_builds_and_runs():
    """The registries hold the reference's names (``traffic_driven`` since
    the serve slice; no map of names still to port is left) and each
    builds through build(RunSpec)."""
    assert set(P.OPTIMIZERS.names()) == set(R.registry.OPTIMIZERS.names())
    assert set(P.POLICIES.names()) == set(R.registry.POLICIES.names())
    assert not hasattr(P.POLICIES, "pending")
    assert not hasattr(P.OPTIMIZERS, "pending")
    data = P.DataSpec(dataset="w8a_like", scale=0.02, lam=1e-3)
    for name in P.OPTIMIZERS.names():
        if name == "adamw_lm":
            continue
        tr = P.build(P.RunSpec(data=data, optimizer=P.OptimizerSpec(name),
                               policy=P.PolicySpec("batch", {"steps": 2})),
                     device="cpu").run()
        assert len(tr.points) == 2 and tr.meta["optimizer"] == name
    for name in P.POLICIES.names():
        sess = P.build(P.RunSpec(
            data=data, schedule=P.ScheduleSpec(n0=64),
            policy=P.PolicySpec(name, {"final_steps": 1}
                                if name not in ("batch", "never_expand")
                                else {"steps": 1})), device="cpu")
        assert np.isfinite(sess.run().final().f_full), name


def test_optimizer_spec_of_round_trips():
    for opt in (TO.NonlinearCG(exact_line_search=False), TO.LBFGS(history=4),
                TO.Adagrad(lr=0.3), TO.AdamW(weight_decay=0.01),
                TO.NewtonCG(hessian_fraction=0.5)):
        spec = P.optimizer_spec_of(opt)
        assert P.build_optimizer(spec) == opt
        assert spec.to_dict() == R.optimizer_spec_of(
            JO.REGISTRY[opt.name](**spec.params)).to_dict()
    with pytest.raises(P.SpecError, match="not registered"):
        P.optimizer_spec_of(TO.api.BatchOptimizer(name="mystery"))


def test_theory_is_the_reference_copy():
    from repro.core import theory as jt
    from repro_torch.core import theory as tt
    assert tt.kappa_hat(3.0) == jt.kappa_hat(3.0)
    assert tt.num_stages(1.0, 1e-3) == jt.num_stages(1.0, 1e-3)
    assert tt.bet_data_accesses(128, 4, 6) == jt.bet_data_accesses(128, 4, 6)
    assert tt.batch_data_accesses(8192, 4, 6) == \
        jt.batch_data_accesses(8192, 4, 6)
    for m in ("batch", "bet", "dsm", "minibatch"):
        kw = dict(a=1.0, p=10.0, s=5.0, kappa=3.0, eps=1e-3, n_bet=1e4)
        assert tt.table1_time(m, **kw) == jt.table1_time(m, **kw)
    assert tt.tolerance_schedule(1.0, 4) == jt.tolerance_schedule(1.0, 4)
    assert tt.estimation_error_bound(1, 2, 1e-3, 100) == \
        jt.estimation_error_bound(1, 2, 1e-3, 100)


def _lines(run) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run()
    return out.getvalue().splitlines()


def test_quickstart_prints_the_reference_lines():
    """The same lines, but for host_transfers (the port's race pulls once
    per chunk of doubling length)."""
    from repro_torch.examples import quickstart
    ref = _lines(lambda: runpy.run_path(str(ROOT / "examples" /
                                            "quickstart.py")))
    port = _lines(lambda: quickstart.main(["--device", "cpu"]))

    def cut(line):
        return line.split("host_transfers=")[0]

    assert [cut(s) for s in port] == [cut(s) for s in ref]
    assert len(port) == 4
