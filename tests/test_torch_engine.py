"""The port's BET engine against the reference, through ``build(RunSpec)``
on both sides: the schedule, scan-stage clock/access columns and f̂ for
``fixed_steps`` and ``batch``, Two-Track trigger steps per stage, the
transfer contract, and that every optimizer step goes through the
``linear_value_grad`` wrapper exactly once."""
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro.core.engine import BETSchedule as JSchedule
from repro_torch.core import engine as tengine
from repro_torch.core.engine import BETSchedule as TSchedule
from repro_torch.kernels import ops as tops

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

COLUMNS = ("step", "stage", "window", "time", "accesses")
# f̂ after up to ~40 float32 Newton-CG steps, summation orders apart: the
# same bound the card-vs-CPU phase of chip_smoke.py uses
RTOL_F = 1e-4


def _spec(policy, params, *, scale=0.05, optimizer="newton_cg"):
    opt_params = {"hessian_fraction": 0.2} if optimizer == "newton_cg" else {}
    return R.RunSpec(
        data=R.DataSpec(dataset="w8a_like", scale=scale, lam=1e-3),
        policy=R.PolicySpec(policy, params),
        optimizer=R.OptimizerSpec(optimizer, opt_params),
        schedule=R.ScheduleSpec(n0=32, clock={"p": 10.0, "a": 1.0, "s": 5.0}))


def _both(spec):
    ref = R.build(spec).run()
    port = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu").run()
    return ref, port


@pytest.mark.parametrize("n0,growth,N", [(128, 2.0, 1024), (200, 2.0, 8192),
                                         (32, 1.5, 409), (7, 3.0, 1000),
                                         (5000, 2.0, 409)])
def test_schedule_windows_equal(n0, growth, N):
    assert TSchedule(n0, growth).windows(N) == JSchedule(n0, growth).windows(N)


@pytest.mark.parametrize("policy,params", [
    ("fixed_steps", {"inner_steps": 4, "final_steps": 8}),
    ("batch", {"steps": 10}),
])
def test_scan_policies_match_reference(policy, params):
    ref, port = _both(_spec(policy, params))
    assert len(port.points) == len(ref.points)
    for col in COLUMNS:
        assert port.column(col) == ref.column(col), col
    np.testing.assert_allclose(port.column("f_window"), ref.column("f_window"),
                               rtol=RTOL_F)
    np.testing.assert_allclose(port.column("f_full"), ref.column("f_full"),
                               rtol=RTOL_F)
    # scan stages keep the reference's one pull per chunk
    assert port.meta["host_transfers"] == ref.meta["host_transfers"]
    assert port.meta["stages"] == ref.meta["stages"]


def test_two_track_trigger_steps_match_reference():
    ref, port = _both(_spec("two_track", {"final_steps": 10}))

    def steps_per_stage(tr):
        stages = tr.column("stage")
        return {s: stages.count(s) for s in sorted(set(stages))}

    assert steps_per_stage(port) == steps_per_stage(ref)
    for col in COLUMNS:
        assert port.column(col) == ref.column(col), col
    np.testing.assert_allclose(port.column("f_full"), ref.column("f_full"),
                               rtol=RTOL_F)
    racing = [p for p in port.points if "f_fast_on_t" in p.extra]
    ref_racing = [p for p in ref.points if "f_fast_on_t" in p.extra]
    np.testing.assert_allclose([p.extra["f_fast_on_t"] for p in racing],
                               [p.extra["f_fast_on_t"] for p in ref_racing],
                               rtol=RTOL_F)
    # the race reads condition (3) once per step from the second on, plus
    # one pull of the stage's histories: s transfers for s race steps
    race_steps = len(racing)
    n_race_stages = port.meta["stages"] - 1
    assert port.meta["host_transfers"] == race_steps + 1
    assert n_race_stages == ref.meta["stages"] - 1


def test_every_optimizer_step_calls_the_kernel_wrapper_once(monkeypatch):
    """On the card, ``ops.CALLS`` counts kernel launches; on the CPU the
    same wrapper serves the plain version, so count its calls here: two
    per race step, one per final-phase and batch step — the equality
    chip_smoke.py asserts on the card."""
    calls = []
    real = tops.linear_value_grad

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tops, "linear_value_grad", counting)
    traces = [P.build(P.RunSpec.from_json(_spec(*pol).to_json()),
                      device="cpu").run()
              for pol in (("two_track", {"final_steps": 6}),
                          ("batch", {"steps": 5}))]
    implied = sum(2 if "f_fast_on_t" in p.extra else 1
                  for tr in traces for p in tr.points)
    assert len(calls) == implied
    assert tops.CALLS["linear_value_grad"] == 0      # the CPU launches nothing


def test_probe_and_progress_hooks():
    sess = P.build(P.RunSpec.from_json(
        _spec("two_track", {"final_steps": 3}).to_json()), device="cpu")
    seen = []
    tr = sess.run(progress=seen.append,
                  probe=lambda w: float(np.abs(w).sum()))
    assert len(seen) == len(tr.points)
    assert all("probe" in p.extra for p in tr.points)
    np.testing.assert_allclose(tr.points[-1].extra["probe"],
                               float(tr.params.abs().sum()), rtol=1e-6)
    assert [e["n_t"] for e in sess.stage_ends] == \
        [i.n_t for i in sess.stage_plan()]


def test_composed_veto_re_races_the_stage():
    """A veto that holds every racing stage for two rounds: the engine
    re-races from the current point, as the reference does."""
    class HoldOnce(tengine.ExpansionPolicy):
        name = "hold_once"

        def stage_begin(self, info):
            self.rounds = 0

        def plan_steps(self, info, done):
            return 1

        def should_expand(self, info, records):
            self.rounds += 1
            return info.is_final or self.rounds >= 2

    policy = tengine.ComposedPolicy(tengine.TwoTrack(final_steps=2),
                                    vetoes=[HoldOnce()])
    sess = P.build(P.RunSpec.from_json(
        _spec("two_track", {"final_steps": 2}).to_json()), device="cpu")
    tr = sess.engine.run(sess.dataset, sess.optimizer, sess.objective, policy,
                         w0=sess.w0, eval_data=sess.eval_data)
    plain = sess.engine.run(sess.dataset, sess.optimizer, sess.objective,
                            tengine.TwoTrack(final_steps=2), w0=sess.w0,
                            eval_data=sess.eval_data)
    assert tr.meta["stages"] == plain.meta["stages"]
    assert len(tr.points) > len(plain.points)


def test_two_track_eval_condition_triggers_where_aux_does():
    """condition="eval" re-evaluates the slow track's f̂_t; on the convex
    path that equals the line search's own value, so the triggers agree."""
    spec = P.RunSpec.from_json(_spec("two_track", {"final_steps": 2}).to_json())
    sess = P.build(spec, device="cpu")
    runs = [sess.engine.run(sess.dataset, sess.optimizer, sess.objective,
                            tengine.TwoTrack(final_steps=2, condition=c),
                            w0=sess.w0, eval_data=sess.eval_data)
            for c in ("aux", "eval")]
    assert runs[0].column("stage") == runs[1].column("stage")
    np.testing.assert_allclose(runs[0].column("f_window"),
                               runs[1].column("f_window"), rtol=1e-5)
