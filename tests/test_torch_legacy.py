"""The port's host-side legacy loops (``repro_torch.core.legacy``) and its
paper-named wrappers (``repro_torch.core.bet``): the loops against the
reference's own legacy loops (columns, f̂, host pulls), the reference's
engine-against-legacy parity tests re-run on the port, its
gradient-variance wrapper tests, the wrappers bit-exact against the
spec-built sessions, and that a loop reads back to the host only at its
counted pulls."""
import collections
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.api as R
import repro_torch.api as P
from repro.core import BETSchedule as JSchedule
from repro.core import SimulatedClock as JClock
from repro.core import legacy as jlegacy
from repro.optim import NewtonCG as JNewtonCG
from repro_torch.core import (BETSchedule, BetEngine, GradientVariance,
                              SimulatedClock, legacy, run_batch,
                              run_bet_fixed, run_gradient_variance,
                              run_two_track)
from repro_torch.data.synthetic import load
from repro_torch.models.linear import init_params, make_objective
from repro_torch.optim import NewtonCG

pytestmark = pytest.mark.tier1

torch.set_num_threads(1)

COLUMNS = ("step", "stage", "window", "time", "accesses")
# port against reference: f̂ after up to ~40 float32 Newton-CG steps,
# summation orders apart (tests/test_torch_engine.py's bound)
RTOL_F = 1e-4
# port engine against port legacy: the reference test's own bound
RTOL_PARITY = 1e-5

# the reference tests' sizes: w8a_like at scale 0.125 (n = 1,024), n0 128
DATA = dict(dataset="w8a_like", scale=0.125, lam=1e-3)
DS = load("w8a_like", scale=0.125, device="cpu")
OBJ = make_objective("squared_hinge", lam=1e-3)
W0 = init_params(DS.d, device="cpu")
OPT = NewtonCG()
SCHED = BETSchedule(n0=128)

LOOPS = {
    "run_bet_fixed": dict(inner_steps=4, final_steps=8),
    "run_two_track": dict(final_steps=8),
    "run_batch": dict(steps=10, record_every=3),
}


def _columns_equal(tr_a, tr_b, cols=COLUMNS):
    assert len(tr_a.points) == len(tr_b.points)
    for col in cols:
        assert tr_a.column(col) == tr_b.column(col), col


def _probe(w):
    return float(np.sum(np.square(np.asarray(w))))


def _both_legacy(name, probe=None):
    """One legacy loop in each package on the same DataSpec's problem,
    with each package's host pulls counted from 0."""
    kw = dict(LOOPS[name])
    jkw, tkw = dict(kw), dict(kw)
    if name != "run_batch":
        jkw["schedule"], tkw["schedule"] = JSchedule(n0=128), SCHED
    if probe is not None:
        jkw["probe"] = tkw["probe"] = probe
    jds, jobj, jw0 = R.convex_problem(R.DataSpec(**DATA))
    tds, tobj, tw0 = P.convex_problem(P.DataSpec(**DATA), device="cpu")
    jlegacy.reset_host_pulls()
    ref = getattr(jlegacy, name)(jds, JNewtonCG(), jobj, clock=JClock(),
                                 w0=jw0, **jkw)
    legacy.reset_host_pulls()
    port = getattr(legacy, name)(tds, NewtonCG(), tobj,
                                 clock=SimulatedClock(), w0=tw0, **tkw)
    return ref, port, jlegacy.host_pulls(), legacy.host_pulls()


# ------------------------------------------------- port against reference
@pytest.mark.parametrize("name", list(LOOPS))
def test_legacy_loops_match_the_reference_legacy_loops(name):
    ref, port, ref_pulls, port_pulls = _both_legacy(name)
    _columns_equal(port, ref)
    assert [(p.stage, p.window) for p in port.points] == \
        [(p.stage, p.window) for p in ref.points]
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(port.column(col), ref.column(col),
                                   rtol=RTOL_F)
    fast = [p.extra.get("f_fast_on_t") for p in port.points]
    ref_fast = [p.extra.get("f_fast_on_t") for p in ref.points]
    assert [f is None for f in fast] == [f is None for f in ref_fast]
    np.testing.assert_allclose([f for f in fast if f is not None],
                               [f for f in ref_fast if f is not None],
                               rtol=RTOL_F)
    assert port_pulls == ref_pulls > 0
    assert port.method == ref.method and port.meta == ref.meta
    assert port.params.device.type == "cpu"
    np.testing.assert_allclose(port.params.numpy(), np.asarray(ref.params),
                               rtol=RTOL_F, atol=1e-6)


def test_legacy_two_track_probe_matches_the_reference():
    ref, port, ref_pulls, port_pulls = _both_legacy("run_two_track",
                                                    probe=_probe)
    _columns_equal(port, ref)
    np.testing.assert_allclose([p.extra["probe"] for p in port.points],
                               [p.extra["probe"] for p in ref.points],
                               rtol=RTOL_F)
    # four pulls a racing step with a probe, two a final step
    racing = sum("f_fast_on_t" in p.extra for p in port.points)
    assert port_pulls == ref_pulls == \
        4 * racing + 2 * (len(port.points) - racing)


@pytest.mark.parametrize("name", list(LOOPS))
def test_legacy_pulls_are_what_the_trace_implies(name):
    """Two pulls a step in ``run_bet_fixed``; three a racing step and one a
    final step in ``run_two_track``; one a recorded step in ``run_batch``
    — the counts chip_smoke.py 3r holds the card to."""
    legacy.reset_host_pulls()
    kw = dict(LOOPS[name])
    if name != "run_batch":
        kw["schedule"] = SCHED
    tr = getattr(legacy, name)(DS, OPT, OBJ, clock=SimulatedClock(), w0=W0,
                               **kw)
    racing = sum("f_fast_on_t" in p.extra for p in tr.points)
    want = {"run_bet_fixed": 2 * len(tr.points),
            "run_two_track": 3 * racing + (len(tr.points) - racing),
            "run_batch": len(tr.points)}[name]
    assert legacy.host_pulls() == want
    assert name != "run_two_track" or racing > 0


class _HostReads(TorchDispatchMode):
    """Counts the operations that read a tensor back on the host."""
    READS = {"_local_scalar_dense", "nonzero", "is_nonzero", "equal"}

    def __init__(self):
        super().__init__()
        self.reads = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.READS:
            self.reads[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(LOOPS))
def test_a_legacy_loop_reads_back_only_at_its_pulls(name):
    """No fallback: nothing in a loop reads a tensor back on the host but
    ``_pull``'s counted ``.item()``; with no ``w0`` the start point is made
    on the dataset's device."""
    kw = dict(LOOPS[name])
    if name != "run_batch":
        kw["schedule"] = SCHED
    legacy.reset_host_pulls()
    with _HostReads() as mode:
        tr = getattr(legacy, name)(DS, OPT, OBJ, clock=SimulatedClock(),
                                   **kw)
    assert dict(mode.reads) == {"_local_scalar_dense": legacy.host_pulls()}
    assert tr.params.device == DS.X.device


def test_pull_counts_one_read_a_call():
    legacy.reset_host_pulls()
    assert legacy._pull(torch.tensor(2.5)) == 2.5
    assert legacy._pull(np.float32(1.5)) == 1.5
    assert legacy.host_pulls() == 2
    legacy.reset_host_pulls()
    assert legacy.host_pulls() == 0


# ------------------- the reference's engine parity tests, re-run on the port
def _deprecated_quietly(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def test_never_expand_matches_legacy_run_batch():
    tr_e = _deprecated_quietly(run_batch, DS, OPT, OBJ, steps=10,
                               record_every=3, clock=SimulatedClock(), w0=W0)
    tr_l = legacy.run_batch(DS, OPT, OBJ, steps=10, record_every=3,
                            clock=SimulatedClock(), w0=W0)
    _columns_equal(tr_e, tr_l)
    np.testing.assert_allclose(tr_e.column("f_window"), tr_l.column("f_window"),
                               rtol=RTOL_PARITY)
    np.testing.assert_allclose(tr_e.column("f_full"), tr_l.column("f_full"),
                               rtol=RTOL_PARITY)


def test_fixed_steps_matches_legacy_run_bet_fixed():
    kw = dict(schedule=SCHED, inner_steps=4, final_steps=8, w0=W0)
    tr_e = _deprecated_quietly(run_bet_fixed, DS, OPT, OBJ,
                               clock=SimulatedClock(), **kw)
    tr_l = legacy.run_bet_fixed(DS, OPT, OBJ, clock=SimulatedClock(), **kw)
    _columns_equal(tr_e, tr_l)
    np.testing.assert_allclose(tr_e.column("f_window"), tr_l.column("f_window"),
                               rtol=RTOL_PARITY)
    np.testing.assert_allclose(tr_e.column("f_full"), tr_l.column("f_full"),
                               rtol=RTOL_PARITY)


def test_two_track_matches_legacy_expansion_points_and_loss():
    kw = dict(schedule=SCHED, final_steps=8, w0=W0)
    tr_e = _deprecated_quietly(run_two_track, DS, OPT, OBJ,
                               clock=SimulatedClock(), **kw)
    tr_l = legacy.run_two_track(DS, OPT, OBJ, clock=SimulatedClock(), **kw)
    assert [(p.stage, p.window) for p in tr_e.points] == \
           [(p.stage, p.window) for p in tr_l.points]
    _columns_equal(tr_e, tr_l)
    np.testing.assert_allclose(tr_e.column("f_window"), tr_l.column("f_window"),
                               rtol=RTOL_PARITY)
    assert tr_e.final().f_window == pytest.approx(tr_l.final().f_window,
                                                  rel=RTOL_PARITY)
    fast_e = [p.extra.get("f_fast_on_t") for p in tr_e.points]
    fast_l = [p.extra.get("f_fast_on_t") for p in tr_l.points]
    assert [f is None for f in fast_e] == [f is None for f in fast_l]
    np.testing.assert_allclose([f for f in fast_e if f is not None],
                               [f for f in fast_l if f is not None],
                               rtol=RTOL_PARITY)


def test_two_track_probe_extra_matches_legacy():
    kw = dict(schedule=SCHED, final_steps=3, w0=W0, probe=_probe)
    tr_e = _deprecated_quietly(run_two_track, DS, OPT, OBJ,
                               clock=SimulatedClock(), **kw)
    tr_l = legacy.run_two_track(DS, OPT, OBJ, clock=SimulatedClock(), **kw)
    np.testing.assert_allclose([p.extra["probe"] for p in tr_e.points],
                               [p.extra["probe"] for p in tr_l.points],
                               rtol=RTOL_PARITY)


# ------------------------------------- the gradient-variance wrapper
def test_gradient_variance_expands_monotonically():
    tr = _deprecated_quietly(run_gradient_variance, DS, OPT, OBJ,
                             schedule=SCHED, theta=0.5, final_steps=10,
                             clock=SimulatedClock(), w0=W0)
    windows = tr.column("window")
    assert all(a <= b for a, b in zip(windows, windows[1:]))
    assert windows[-1] == DS.n                 # reaches the full dataset
    assert tr.final().f_full < tr.points[0].f_full
    assert tr.meta["policy"] == "bet_gradvar"
    assert tr.meta["theta"] == 0.5


def test_gradient_variance_records_stats():
    eng = BetEngine(schedule=SCHED)
    tr = eng.run(DS, OPT, OBJ, GradientVariance(theta=0.5, final_steps=4),
                 clock=SimulatedClock(), w0=W0)
    # a non-final stage only ends when the variance test (or the cap) fires
    assert tr.meta["stages"] == len(set(tr.column("stage")))


# ------------------------- the wrappers against the spec-built sessions
SPEC_DATA = P.DataSpec(dataset="w8a_like", scale=0.02)
SPEC_OPT = P.OptimizerSpec("newton_cg", {"hessian_fraction": 1.0})
WRAPPERS = {
    "run_bet_fixed": (dict(inner_steps=2, final_steps=3),
                      P.PolicySpec("fixed_steps", {"inner_steps": 2,
                                                   "final_steps": 3})),
    "run_two_track": (dict(final_steps=3),
                      P.PolicySpec("two_track", {"final_steps": 3})),
    "run_batch": (dict(steps=4), P.PolicySpec("batch", {"steps": 4})),
    "run_gradient_variance": (
        dict(theta=0.5, final_steps=3),
        P.PolicySpec("gradient_variance", {"theta": 0.5, "final_steps": 3})),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_deprecated_wrappers_match_spec_sessions_bit_exactly(name):
    import repro_torch.core.bet as bet
    kw, policy = WRAPPERS[name]
    ds, obj, w0 = P.convex_problem(SPEC_DATA, device="cpu")
    if name != "run_batch":
        kw = dict(kw, schedule=BETSchedule(n0=32))
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        tr_old = getattr(bet, name)(ds, NewtonCG(hessian_fraction=1.0), obj,
                                    clock=SimulatedClock(), w0=w0, **kw)
    spec = P.RunSpec(data=SPEC_DATA, policy=policy, optimizer=SPEC_OPT,
                     schedule=P.ScheduleSpec(n0=32))
    tr_new = P.build(spec, device="cpu").run()
    for col in ("f_window", "f_full", "time", "accesses", "window"):
        assert tr_old.column(col) == tr_new.column(col), col
    assert torch.equal(tr_old.params, tr_new.params)
