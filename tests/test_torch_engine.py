"""The port's BET engine against the reference, through ``build(RunSpec)``
on both sides: the schedule, scan-stage clock/access columns and f̂ for
``fixed_steps`` and ``batch``, Two-Track trigger steps per stage, the
transfer contract (one pull a racing stage, as the reference's
``lax.while_loop``), the race's carry at the trigger, and that every
optimizer step goes through the ``linear_value_grad`` wrapper exactly
once."""
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


def _chunk_end(s):
    """The cumulative chunk boundary (2, 4, 8, ...) that step s was in
    when the race ran in doubling chunks: what the device loop no longer
    runs past a trigger."""
    end = 2
    while end < s:
        end *= 2
    return end


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
    # the race pulls once a racing stage, as the reference's while loop
    # does; the final phase's one chunk costs one more
    n_race_stages = port.meta["stages"] - 1
    per_stage = [c for s, c in steps_per_stage(port).items()
                 if any(p.stage == s and "f_fast_on_t" in p.extra
                        for p in racing)]
    assert len(per_stage) == n_race_stages == ref.meta["stages"] - 1
    assert port.meta["host_transfers"] == ref.meta["host_transfers"] == \
        n_race_stages + 1 == port.meta["stages"]
    # the loop stops at the trigger: no step runs past it
    assert port.meta["race_overshoot"] == 0


def test_every_optimizer_step_calls_the_kernel_wrapper_once(monkeypatch):
    """On the card, ``ops.CALLS`` counts kernel launches; on the CPU the
    same wrapper serves the plain version, so count its calls here: two
    per race step (none runs past a trigger), one per final-phase and
    batch step — the equality chip_smoke.py asserts on the card."""
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
    assert all(tr.meta["race_overshoot"] == 0 for tr in traces)
    assert len(calls) == implied
    assert tops.CALLS["linear_value_grad"] == 0      # the CPU launches nothing


@pytest.mark.parametrize("optimizer,overshoot", [("newton_cg", 2), ("gd", 14)])
def test_race_overshoot_rolls_back_to_the_trigger(optimizer, overshoot):
    """susy_like triggers mid-chunk (after 6 race steps with Newton-CG, 18
    with GD): a race in doubling chunks ran ``overshoot`` steps past the
    trigger and rolled the slow track back.  The device loop stops at the
    trigger: overshoot 0, one pull a racing stage, and each stage's slow
    carry is bitwise that of as many plain optimizer steps on the stage
    window from the stage's start, the device step counter of Newton-CG
    included."""
    spec = P.RunSpec.from_json(_spec("two_track", {"final_steps": 2},
                                     optimizer=optimizer).to_json())
    spec = spec.replace(data=spec.data.replace(dataset="susy_like"))
    sess = P.build(spec, device="cpu")
    ends, record = [], sess.engine.stage_callback
    sess.engine.stage_callback = lambda end: (
        ends.append((end.info, end.params, end.opt_state)), record(end))
    w = sess.w0.clone()
    tr = sess.run()
    assert tr.meta["race_overshoot"] == 0
    stages = tr.column("stage")
    race = [stages.count(s) for s in sorted(set(stages))][:-1]
    assert sum(_chunk_end(s) - s for s in race) == overshoot
    assert tr.meta["host_transfers"] == len(race) + 1
    assert len(ends) == tr.meta["stages"]
    opt, obj = sess.optimizer, sess.objective
    for (info, w_end, st_end), steps in zip(ends, race):
        win = sess.dataset.window(info.n_t)
        st = opt.init(w)
        for _ in range(steps):
            w, st, _ = opt.step(w, st, obj, win)
        assert torch.equal(w, w_end)
        assert st.keys() == st_end.keys()
        for k in st:
            assert torch.equal(st[k], st_end[k]), k


def test_probe_and_progress_hooks():
    """``progress`` sees every point and ``probe`` every step's
    parameters.  A racing stage's parameters come back in its one pull
    (the buffer ``W``, written at the device step index): each equals
    the slow track after that many plain optimizer steps from the stage's
    start."""
    sess = P.build(P.RunSpec.from_json(
        _spec("two_track", {"final_steps": 3}).to_json()), device="cpu")
    seen, probed = [], []
    w = sess.w0.clone()
    tr = sess.run(progress=seen.append,
                  probe=lambda p: (probed.append(np.array(p)),
                                   float(np.abs(p).sum()))[1])
    assert len(seen) == len(tr.points) == len(probed)
    assert all("probe" in p.extra for p in tr.points)
    np.testing.assert_allclose(tr.points[-1].extra["probe"],
                               float(tr.params.abs().sum()), rtol=1e-6)
    assert [e["n_t"] for e in sess.stage_ends] == \
        [i.n_t for i in sess.stage_plan()]
    assert tr.meta["host_transfers"] == tr.meta["stages"]
    stages = tr.column("stage")
    opt, obj = sess.optimizer, sess.objective
    i = 0
    for info in sess.stage_plan()[:-1]:
        win = sess.dataset.window(info.n_t)
        st = opt.init(w)
        for _ in range(stages.count(info.stage)):
            w, st, _ = opt.step(w, st, obj, win)
            np.testing.assert_array_equal(probed[i], w.numpy())
            i += 1
    assert i == len(tr.points) - 3


def test_composed_veto_re_races_the_stage():
    """A veto that holds every racing stage for two rounds: the engine
    re-races from the current point, as the reference does; each round
    runs one loop (one capture on the card, or a replay of the kept
    graph; the plain loop here) and pulls once."""
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
    rounds = len(sess.engine.race_capture_s)
    plain = sess.engine.run(sess.dataset, sess.optimizer, sess.objective,
                            tengine.TwoTrack(final_steps=2), w0=sess.w0,
                            eval_data=sess.eval_data)
    assert tr.meta["stages"] == plain.meta["stages"]
    assert len(tr.points) > len(plain.points)
    # the veto holds every racing stage but the last (its window is the
    # whole data, and the veto lets it go)
    racing = sess.engine.stage_infos(policy, sess.dataset.n)[:-1]
    assert rounds == sum(1 if i.is_final else 2 for i in racing)
    assert len(sess.engine.race_capture_s) == len(racing)
    assert tr.meta["host_transfers"] == rounds + 1
    assert plain.meta["host_transfers"] == len(racing) + 1
    assert tr.meta["race_overshoot"] == 0


def test_two_track_eval_condition_triggers_where_aux_does():
    """condition="eval" re-evaluates the slow track's f̂_t inside the race
    step; on the convex path that equals the line search's own value, so
    the triggers agree."""
    spec = P.RunSpec.from_json(_spec("two_track", {"final_steps": 2}).to_json())
    sess = P.build(spec, device="cpu")
    runs = [sess.engine.run(sess.dataset, sess.optimizer, sess.objective,
                            tengine.TwoTrack(final_steps=2, condition=c),
                            w0=sess.w0, eval_data=sess.eval_data)
            for c in ("aux", "eval")]
    assert runs[0].column("stage") == runs[1].column("stage")
    np.testing.assert_allclose(runs[0].column("f_window"),
                               runs[1].column("f_window"), rtol=1e-5)
    assert runs[0].meta["host_transfers"] == runs[1].meta["host_transfers"] \
        == runs[0].meta["stages"]
