"""``ObsSpec`` through the port's ``build``, on the CPU, against the
reference on the same specs: the reference's session cases of
``tests/test_obs.py`` (the RunReport round trip with claims and meters,
``run_report`` without obs, obs off bit for bit obs on, a resumed run's
counters continuing), the events per stage of an observed two-track run
name for name, and the profiler (``profile.stage`` once a stage with FLOPs
and roofline seconds, the trajectory untouched, a ``torch.profiler``
Chrome trace, B1–B4's plain-version costs)."""
from __future__ import annotations

import collections
import json

import pytest
import torch

import repro.api as R
from repro_torch import api as P
from repro_torch.obs import RunReport, from_jsonl, validate_events
from repro_torch.obs import profile as tprofile

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

DATA = dict(dataset="w8a_like", scale=0.02, plane="plane", shard_size=32)
FIXED = ("fixed_steps", {"inner_steps": 2, "final_steps": 3})
TWO_TRACK = ("two_track", {"final_steps": 3})
OPT = ("newton_cg", {"hessian_fraction": 1.0})


def _spec(pkg, policy=FIXED, **kw):
    base = dict(data=pkg.DataSpec(**DATA), policy=pkg.PolicySpec(*policy),
                optimizer=pkg.OptimizerSpec(*OPT),
                schedule=pkg.ScheduleSpec(n0=32))
    base.update(kw)
    return pkg.RunSpec(**base)


def _claims(report) -> dict:
    """A RunReport's claims but ``overlap_ge_half``, which compares load
    and compute wall seconds and so differs from run to run."""
    return {k: v for k, v in report.claims().items()
            if k != "overlap_ge_half"}


def _per_stage_names(events, skip=("prefetch.", "meter.", "clock.")):
    out = collections.Counter()
    for e in events:
        if e["name"].startswith(skip):
            continue
        out[(e["name"], (e.get("tags") or {}).get("stage"))] += 1
    return out


def test_session_run_report_roundtrip_claims_and_meter_match(tmp_path):
    spec = _spec(P, obs=P.ObsSpec(enabled=True, dir=str(tmp_path / "obs"),
                                  chrome_trace=True))
    sess = P.build(spec, device="cpu")
    tr = sess.run()
    rr = sess.run_report()
    snap = sess.meters["data_plane"]
    assert rr.matches_meter(snap), rr.meter_mismatches(snap)
    claims = rr.claims()
    assert all(v for v in _claims(rr).values()), claims
    ref = R.build(_spec(R, obs=R.ObsSpec(enabled=True)))
    ref.run()
    assert _claims(rr) == _claims(ref.run_report())
    rows = rr.stage_rows()
    assert len(rows) == tr.meta["stages"]
    assert rows[-1]["window"] == sess.dataset.n
    assert sum(r["steps"] for r in rows) == len(tr.points)
    assert sum(r["clock_accesses"] for r in rows) == sess.clock.data_accesses
    files = tr.meta["obs_files"]
    assert validate_events(from_jsonl(files["events"])) == []
    rr2 = RunReport.from_jsonl(files["events"])
    assert rr2.to_dict() == rr.to_dict()
    assert rr2.matches_meter(snap)
    chrome = json.loads((tmp_path / "obs" / "trace.json").read_text())
    assert chrome["traceEvents"]
    report = json.loads((tmp_path / "obs" / "report.json").read_text())
    assert report["claims"] == {k: bool(v) if v is not None else None
                                for k, v in claims.items()}
    assert (tmp_path / "obs" / "report.txt").read_text().startswith("stage")


def test_run_report_without_obs_raises():
    sess = P.build(_spec(P), device="cpu")
    assert sess.recorder is None
    with pytest.raises(P.SpecError, match="obs.enabled"):
        sess.run_report()
    with pytest.raises(P.SpecError, match="obs.health"):
        sess.health_report()
    with pytest.raises(P.SpecError, match="obs.fleet"):
        sess.fleet_trace()


@pytest.mark.parametrize("policy", [FIXED, TWO_TRACK],
                         ids=["fixed_steps", "two_track"])
def test_obs_disabled_trajectory_bit_identical(policy):
    """Obs off, and fully on (profile and health included): the same
    trace bit for bit, the final parameters too."""
    tr_off = P.build(_spec(P, policy), device="cpu").run()
    tr_on = P.build(_spec(P, policy, obs=P.ObsSpec(
        enabled=True, profile=True, health=True)), device="cpu").run()
    for col in ("f_window", "f_full", "time", "accesses", "window"):
        assert tr_on.column(col) == tr_off.column(col)
    assert [p.extra for p in tr_on.points] == [p.extra for p in tr_off.points]
    assert tr_on.meta["host_transfers"] == tr_off.meta["host_transfers"]
    assert torch.equal(tr_on.params, tr_off.params)


def test_two_track_events_per_stage_are_the_references():
    """An observed two-track run: the same events per stage as the
    reference's (one ``engine.transfer`` a racing stage), ``run.meta``
    included, and the RunReport's claims equal."""
    ref = R.build(_spec(R, TWO_TRACK, obs=R.ObsSpec(enabled=True)))
    ref.run()
    sess = P.build(_spec(P, TWO_TRACK, obs=P.ObsSpec(enabled=True)),
                   device="cpu")
    tr = sess.run()
    got, want = sess.recorder.event_dicts(), ref.recorder.event_dicts()
    assert _per_stage_names(got) == _per_stage_names(want)
    transfers = collections.Counter(
        (e.get("tags") or {}).get("stage") for e in got
        if e["name"] == "engine.transfer")
    assert set(transfers.values()) == {1}
    assert len(transfers) == tr.meta["stages"]
    assert _claims(sess.run_report()) == _claims(ref.run_report())
    (meta,) = [e for e in got if e["name"] == "run.meta"]
    (jmeta,) = [e for e in want if e["name"] == "run.meta"]
    assert meta["fields"] == jmeta["fields"]


def test_resumed_run_continues_counters_bit_compatibly(tmp_path):
    spec = _spec(P, obs=P.ObsSpec(enabled=True))
    ref = P.build(spec, device="cpu")
    ref_tr = ref.run()
    ref_final = ref.run_report().named("stage.totals")[-1]["fields"]
    spec = spec.replace(checkpoint=P.CheckpointSpec(directory=str(tmp_path),
                                                    keep=99))

    class _Killed(Exception):
        pass

    sess = P.build(spec, device="cpu")

    def die(end):
        if end.info.stage == 1:
            raise _Killed

    sess.on_stage(die)
    with pytest.raises(_Killed):
        sess.run()
    killed = RunReport.from_recorder(sess.recorder).named("stage.totals")
    resumed = P.build(spec.replace(checkpoint=spec.checkpoint.replace(
        resume=True)), device="cpu")
    tr = resumed.run()
    totals = RunReport.from_recorder(resumed.recorder).named("stage.totals")
    assert [t["tags"]["stage"] for t in killed] == [0, 1]
    assert [t["tags"]["stage"] for t in totals] == \
        list(range(2, 2 + len(totals)))
    assert [s["fields"]["accesses"] for s in killed + totals] == \
        [t["fields"]["accesses"]
         for t in ref.run_report().named("stage.totals")]
    final = totals[-1]["fields"]
    for k in ("time", "accesses", "loaded", "steps", "window"):
        assert final[k] == ref_final[k], k
    assert resumed.meters["clock"] == ref.meters["clock"]
    n = len(tr.column("f_full"))
    assert tr.column("f_full") == ref_tr.column("f_full")[-n:]


@pytest.mark.parametrize("policy", [FIXED, TWO_TRACK],
                         ids=["fixed_steps", "two_track"])
def test_profile_costs_each_stage_once_with_h100_roofline(policy, tmp_path):
    """``ObsSpec.profile``: one ``profile.stage`` event a stage, as the
    reference emits, each with FLOPs, bytes and roofline seconds at the
    H100's float32 peak and no error; the torch.profiler trace lands in
    ``jax_profiler_dir``."""
    prof_dir = tmp_path / "prof"
    spec = _spec(P, policy, obs=P.ObsSpec(enabled=True, profile=True,
                                          jax_profiler_dir=str(prof_dir)))
    sess = P.build(spec, device="cpu")
    tr = sess.run()
    events = sess.recorder.event_dicts()
    got = [e["fields"] for e in events if e["name"] == "profile.stage"]
    ref = R.build(_spec(R, policy, obs=R.ObsSpec(enabled=True,
                                                 profile=True)))
    ref.run()
    want = [e["fields"] for e in ref.recorder.event_dicts()
            if e["name"] == "profile.stage"]
    assert [(f["stage"], f["n_t"]) for f in got] == \
        [(f["stage"], f["n_t"]) for f in want]
    assert len(got) == tr.meta["stages"]
    for f in got:
        assert "error" not in f, f
        assert f["flops"] > 0 and f["bytes"] > 0
        assert f["peak_flops"] == tprofile.PEAK_FLOPS[torch.float32]
        assert f["roofline_us"] == pytest.approx(
            max(f["flops"] / f["peak_flops"], f["bytes"] / f["hbm_bw"]) * 1e6)
    trace = json.loads((prof_dir / "trace.json").read_text())
    assert trace["traceEvents"]


def test_seed_kernel_costs_cover_the_four_kernels():
    costs = tprofile.seed_kernel_costs()
    assert set(costs) == {"linear_forward", "linear_value_grad",
                          "flash_attention", "ssm_scan", "rglru_scan"}
    for name, c in costs.items():
        assert "error" not in c, (name, c)
        assert c["flops"] > 0 and c["bytes"] > 0 and c["roofline_us"] > 0
