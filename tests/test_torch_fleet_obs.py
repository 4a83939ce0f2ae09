"""Fleet observability in the port, on the CPU, against the reference:
the cases of ``tests/test_fleet_obs.py`` run on the port's copies of
``obs/fleet.py``, ``obs/health.py`` and ``obs/regress.py`` and, where a
run or a stream is involved, on the reference's beside them with the
same specs and the same events — per-host lanes and their barriers, the
merge's clock alignment and causal order, the 4-host run's lane files and
merged trace, each detector fed one event stream giving the reference's
detections, spec validation, and the regression sentinel on the committed
``BENCH_*.json`` anchors.

The straggler is held two ways that cannot flake on a loaded machine: a
recorded ``meter.load`` stream (host 2's loads 40× the others') fed to
both packages' detectors, and an end-to-end 4-host run whose injected
``slow@`` delay (0.25 s a load) is ~1,000× the other hosts' 0.2 ms
loads, far above the 4× ratio (the reference's own end-to-end case
injects 0.05 s)."""
from __future__ import annotations

import json
import math
import os

import pytest
import torch

import repro.api as R
import repro.obs.fleet as jfleet
import repro.obs.health as jhealth
from repro_torch import api as P
from repro_torch.obs import EventRecorder, validate_events
from repro_torch.obs import events as ev
from repro_torch.obs import fleet as fleet_mod
from repro_torch.obs import regress
from repro_torch.obs.fleet import BARRIER, DRIVER, FleetRecorder, \
    merge_streams
from repro_torch.obs.health import SLO_DEFAULTS, HealthMonitor, HealthReport

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRAGGLER_SLO = {"straggler_ratio": 4.0, "straggler_min_loads": 2}


def _fleet_spec(pkg, workdir, **kw):
    base = dict(
        data=pkg.DataSpec(dataset="w8a_like", scale=0.05, plane="plane",
                          store="memmap", workdir=str(workdir),
                          shard_size=16, delay_ms=0.2),
        policy=pkg.PolicySpec("fixed_steps", {"inner_steps": 3,
                                              "final_steps": 5}),
        optimizer=pkg.OptimizerSpec("newton_cg", {"hessian_fraction": 1.0}),
        schedule=pkg.ScheduleSpec(n0=64), topology=pkg.TopologySpec(hosts=4))
    base.update(kw)
    return pkg.RunSpec(**base)


def _names(stream):
    return [e["name"] for e in stream]


# ------------------------------------------------------------ FleetRecorder
def test_fleet_recorder_lanes_barriers_and_save(tmp_path):
    fr, jfr = FleetRecorder(hosts=(0, 1)), jfleet.FleetRecorder(hosts=(0, 1))
    for rec in (fr, jfr):
        rec.instant("driver.ev", x=1)
        rec.lane(0).instant("h0.ev")
        rec.lane(1).instant("h1.ev")
        rec.barrier(stage=0, n_t=64)
    assert len(fr) == len(jfr) == 2
    streams, jstreams = fr.streams(), jfr.streams()
    assert set(streams) == set(jstreams) == {DRIVER, 0, 1}
    for key, stream in streams.items():
        assert _names(stream) == _names(jstreams[key])
        assert [e["tags"] for e in stream] == \
            [e["tags"] for e in jstreams[key]]
        assert validate_events(stream) == []
    paths = fr.save(tmp_path)
    assert sorted(os.path.basename(p) for p in paths.values()) == \
        ["events_driver.jsonl", "events_host0.jsonl", "events_host1.jsonl"]
    assert fleet_mod.main([str(tmp_path),
                           "--out", str(tmp_path / "fleet.jsonl")]) == 0
    version, merged = ev.read_log(tmp_path / "fleet.jsonl")
    assert version == ev.FLEET_SCHEMA_VERSION
    assert len(merged) == sum(len(s) for s in streams.values())


def test_fleet_listener_taps_every_lane_including_late_ones():
    fr = FleetRecorder(hosts=(0,))
    seen = []
    fr.add_listener(lambda e: seen.append(e["name"]))
    fr.instant("d")
    fr.lane(0).instant("h0")
    fr.lane(7).instant("h7")
    assert seen == ["d", "h0", "h7"]


def test_merge_realigns_injected_clock_skew():
    fr = FleetRecorder(hosts=(0, 1), skew={1: 50.0})
    fr.lane(0).instant("a0")
    fr.lane(1).instant("a1")
    fr.barrier(stage=0)
    fr.lane(0).instant("b0")
    fr.lane(1).instant("b1")
    fr.barrier(stage=1)
    tr = fr.merged()
    assert abs(tr.hosts[1]["offset_s"] + 50.0) < 1.0
    assert abs(tr.hosts[0]["offset_s"]) < 1.0
    a1 = next(e for e in tr.events if e["name"] == "a1")
    b0 = next(e for e in tr.events if e["name"] == "b0")
    assert a1["seq"] < b0["seq"] and a1["t_raw"] > b0["t_raw"]
    # the reference's merger orders the same streams the same way
    jtr = jfleet.merge_streams(fr.streams())
    assert _names(jtr.events) == _names(tr.events)
    assert tr.summary()["reference"] == DRIVER


def test_merge_is_causal_at_stage_barriers():
    fr = FleetRecorder(hosts=(0, 1), skew={1: 1000.0})
    fr.lane(1).instant("pre1")
    fr.lane(0).instant("pre0")
    fr.barrier(stage=0)
    fr.lane(0).instant("post0")
    fr.lane(1).instant("post1")
    lanes = {k: v for k, v in fr.streams().items() if k != DRIVER}
    tr = merge_streams(lanes)
    names = _names(tr.events)
    assert max(names.index("pre0"), names.index("pre1")) < \
        min(names.index("post0"), names.index("post1"))
    for key in (0, 1):
        seqs = [e["lane_seq"] for e in tr.events if e["lane"] == key]
        assert seqs == sorted(seqs)
    assert names == _names(jfleet.merge_streams(lanes).events)


# -------------------------------------------------------- 4-host fleet run
def _lane_counts(ft, name):
    return {h: sum(1 for e in ft.events if e["lane"] == h
                   and e["name"] == name) for h in range(4)}


def test_four_host_run_writes_lanes_and_merged_causal_trace(tmp_path):
    obs_dir = tmp_path / "obs"
    obs = dict(enabled=True, fleet=True, health=True, dir=str(obs_dir),
               chrome_trace=True)
    sess = P.build(_fleet_spec(P, tmp_path / "port", obs=P.ObsSpec(**obs)),
                   device="cpu")
    tr = sess.run()
    ref = R.build(_fleet_spec(R, tmp_path / "ref", obs=R.ObsSpec(
        **dict(obs, dir=str(tmp_path / "ref_obs")))))
    ref.run()
    files = tr.meta["obs_files"]
    assert set(files["lanes"]) == {0, 1, 2, 3, DRIVER}
    for p in files["lanes"].values():
        version, events = ev.read_log(p)
        assert version == ev.SCHEMA_VERSION
        assert validate_events(events) == []
    ft, jft = sess.fleet_trace(), ref.fleet_trace()
    # each host's lane carries its own loads, as many as the reference's
    assert _lane_counts(ft, "meter.load") == _lane_counts(jft, "meter.load")
    assert all(_lane_counts(ft, "meter.load").values())
    last: dict = {}
    for e in ft.events:
        assert e["lane_seq"] > last.get(e["lane"], -1)
        last[e["lane"]] = e["lane_seq"]
    stages = sorted({e["fields"]["stage"] for e in ft.events
                     if e["name"] == BARRIER})
    assert stages == sorted({e["fields"]["stage"] for e in jft.events
                             if e["name"] == BARRIER})
    for s in stages:
        last_bar = max(i for i, e in enumerate(ft.events)
                       if e["name"] == BARRIER and e["fields"]["stage"] == s)
        assert {e["lane"] for e in ft.events[:last_bar + 1]
                if e["name"] == BARRIER and e["fields"]["stage"] == s} == \
            {DRIVER, 0, 1, 2, 3}
    version, merged = ev.read_log(files["fleet"])
    assert version == ev.FLEET_SCHEMA_VERSION
    assert validate_events(merged) == [] and len(merged) == len(ft.events)
    assert ev.main([str(files["fleet"])]) == 0
    assert ev.main([str(files["events"])]) == 0
    summary = json.loads((obs_dir / "fleet.json").read_text())
    assert set(summary["hosts"]) == {"driver", "0", "1", "2", "3"}
    chrome = json.loads((obs_dir / "fleet_trace.json").read_text())
    names = {r["args"]["name"] for r in chrome["traceEvents"]
             if r.get("ph") == "M" and r["name"] == "process_name"}
    assert {"host 0", "host 1", "host 2", "host 3", "host driver"} <= names
    claims, jclaims = sess.run_report().claims(), ref.run_report().claims()
    claims.pop("overlap_ge_half"), jclaims.pop("overlap_ge_half")
    assert claims == jclaims
    assert claims["per_host_loads_are_owned_slice"] is True
    assert claims["each_example_loaded_once"] is True
    assert (obs_dir / "health.json").exists()


def _load_stream(slow_host=2, slow_s=0.4, fast_s=0.01, loads=6):
    """A recorded 4-host ``meter.load`` stream: every host loads in turn,
    host ``slow_host`` 40x slower than the others."""
    out = []
    for i in range(loads):
        for h in range(4):
            out.append(("meter.load", {"host": h},
                        {"duration_s": slow_s if h == slow_host else fast_s,
                         "blocked_s": 0.0, "nbytes": 1024, "examples": 16,
                         "i": i}))
    return out


def _feed(rec_cls, mon_cls, stream, slo):
    rec, mon = rec_cls(), mon_cls(slo=slo)
    mon.attach(rec)
    for name, tags, fields in stream:
        rec.instant(name, tags=tags, **fields)
    return [(d.kind, d.stage, d.host) for d in mon.detections], mon, rec


def test_slow_fault_is_flagged_by_straggler_detector_before_run_ends(
        tmp_path):
    """The recorded stream: both packages' detectors flag host 2, and only
    it.  End to end over 4 hosts, a host 2 made 0.25 s slower a load
    after stage 1: flagged live, before the run's last ``stage.end``, and
    re-found by replaying the merged trace."""
    stream = _load_stream()
    got, _, rec = _feed(EventRecorder, HealthMonitor, stream, STRAGGLER_SLO)
    want, _, _ = _feed(jfleet.EventRecorder, jhealth.HealthMonitor, stream,
                       STRAGGLER_SLO)
    assert got == want and {h for _, _, h in got} == {2}
    assert [e["name"] for e in rec.event_dicts()
            if e["name"].startswith("health.")] == ["health.straggler"]

    detected = []
    sess = P.build(_fleet_spec(
        P, tmp_path, elastic=P.ElasticSpec(faults=("slow@1:2=0.25",)),
        obs=P.ObsSpec(enabled=True, fleet=True, health=True,
                      slo=STRAGGLER_SLO)), device="cpu")
    sess.health.on_detection(detected.append)
    sess.run()
    hr = sess.health_report()
    assert 2 in {d.host for d in hr.detections if d.kind == "straggler"}
    assert not hr.healthy
    ft = sess.fleet_trace()
    det = [e["seq"] for e in ft.events if e["name"] == "health.straggler"
           and e["tags"].get("host") == 2]
    ends = [e["seq"] for e in ft.events if e["name"] == "stage.end"]
    assert det and min(det) < max(ends)
    assert any(d.kind == "straggler" and d.host == 2 for d in detected)
    replay = HealthReport.from_events(ft.events, slo=STRAGGLER_SLO)
    assert any(d.kind == "straggler" and d.host == 2
               for d in replay.detections)


@pytest.mark.parametrize("change,match", [
    (dict(obs=dict(fleet=True)), "ObsSpec.fleet"),
    (dict(hosts=1, obs=dict(enabled=True, fleet=True)), "hosts > 1"),
    (dict(obs=dict(health=True)), "ObsSpec.health"),
    (dict(obs=dict(enabled=True, health=True, slo={"nope": 1})),
     "slo knobs"),
], ids=["fleet_off", "one_host", "health_off", "slo"])
def test_fleet_spec_validation(change, match):
    for pkg, kw in ((R, {}), (P, {"device": "cpu"})):
        spec = _fleet_spec(pkg, "/tmp/x", obs=pkg.ObsSpec(**change["obs"]))
        if change.get("hosts"):
            spec = spec.replace(topology=pkg.TopologySpec(hosts=1),
                                data=spec.data.replace(store="memory",
                                                       workdir=None))
        with pytest.raises(pkg.SpecError, match=match):
            pkg.build(spec, **kw)


# -------------------------------------------------------- health detectors
def _both(stream, **slo):
    """The detections of the port's and the reference's monitors over one
    event stream, with the port's monitor and recorder."""
    got, mon, rec = _feed(EventRecorder, HealthMonitor, stream, slo)
    want, _, _ = _feed(jfleet.EventRecorder, jhealth.HealthMonitor, stream,
                       slo)
    assert got == want
    return mon, rec


def test_staleness_slo_detector_and_emitted_health_events():
    mon, rec = _both([("serve.staleness", None, {"staleness": 1}),
                      ("serve.staleness", None, {"staleness": None}),
                      ("serve.staleness", None, {"staleness": 3})],
                     staleness_max=1)
    (d,) = mon.detections
    assert d.kind == "staleness_slo" and d.fields["staleness"] == 3
    health = [e for e in rec.event_dicts()
              if e["name"] == "health.staleness_slo"]
    assert len(health) == 1 and health[0]["fields"]["staleness"] == 3
    det = mon.detector("staleness_slo")
    assert det.samples == 3 and det.breaches == 1
    assert mon.events_seen == 3


def test_expansion_stall_detector_and_late_hold_limit():
    for pkg_rec, pkg_mon in ((EventRecorder, HealthMonitor),
                             (jfleet.EventRecorder, jhealth.HealthMonitor)):
        rec, mon = pkg_rec(), pkg_mon(slo={"hold_frac": 0.8})
        mon.attach(rec)
        rec.instant("serve.hold", stage=1, holds=9)
        assert not mon.detections
        mon.set_hold_limit(10)
        mon.set_hold_limit(10_000)
        for stage, holds in ((1, 7), (1, 8), (1, 9), (2, 8)):
            rec.instant("serve.hold", stage=stage, holds=holds)
        assert [(d.kind, d.stage) for d in mon.detections] == \
            [("expansion_stall", 1), ("expansion_stall", 2)]


def test_overlap_collapse_detector_rearms_on_recovery():
    load = lambda blocked: ("meter.load", None,  # noqa: E731
                            {"duration_s": 1.0, "blocked_s": blocked})
    stream = [load(0.9)] * 3 + [load(0.0)] * 20 + [load(1.0)] * 60
    mon, _ = _both(stream, overlap_floor=0.5, overlap_min_loads=2)
    assert [d.kind for d in mon.detections] == ["overlap_collapse"] * 2
    assert mon.detections[0].fields["overlap"] < 0.5


def test_nonfinite_loss_detector():
    for pkg_rec, pkg_mon in ((EventRecorder, HealthMonitor),
                             (jfleet.EventRecorder, jhealth.HealthMonitor)):
        rec, mon = pkg_rec(), pkg_mon()
        mon.attach(rec)
        rec.set_context(stage=2)
        for f in (1.25, None, float("nan"), float("inf")):
            rec.instant("expand.decision", f_last=f)
        (d,) = mon.detections
        assert d.kind == "nonfinite_loss" and d.stage == 2
        assert math.isnan(float(d.fields["f_last"]))


def test_health_monitor_rejects_unknown_slo_and_report_round_trips(
        tmp_path):
    with pytest.raises(ValueError, match="unknown slo"):
        HealthMonitor(slo={"bogus": 1})
    mon, _ = _both([("serve.staleness", None, {"staleness": 2})],
                   staleness_max=0)
    rep = mon.report()
    assert not rep.healthy and rep.events_seen == 1
    assert set(rep.detectors) == {d.kind for d in mon.detectors}
    paths = rep.save(tmp_path)
    saved = json.loads((tmp_path / "health.json").read_text())
    assert saved["healthy"] is False
    assert saved["detections"][0]["kind"] == "staleness_slo"
    assert (tmp_path / "health.txt").read_text().startswith(
        "health: DEGRADED")
    assert set(paths) == {"health_json", "health_txt"}
    assert set(rep.slo) == set(SLO_DEFAULTS) == set(jhealth.SLO_DEFAULTS)


# --------------------------------------------------------- regression gate
def _anchors():
    out = {}
    for module in regress.MODULES:
        with open(os.path.join(REPO_ROOT, f"BENCH_{module}.json")) as fh:
            out[module] = json.load(fh)
    return out


def test_sentinel_passes_on_committed_anchors(capsys):
    for module, anchor in _anchors().items():
        assert regress.compare(module, anchor, anchor) == []
    assert regress.main(["--check", REPO_ROOT]) == 0
    assert "0 regression(s)" in capsys.readouterr().out


def test_sentinel_fails_readably_on_degraded_claims_and_metrics(tmp_path,
                                                                capsys):
    from repro.obs import regress as jregress
    anchors = _anchors()
    degraded = json.loads(json.dumps(anchors["dist"]))
    claim = next(k for k, v in degraded["claims"].items() if v)
    degraded["claims"][claim] = False
    degraded["trajectory_max_rel_dev"] = 0.5
    deltas = regress.compare("dist", anchors["dist"], degraded)
    assert [str(d) for d in deltas] == \
        [str(d) for d in jregress.compare("dist", anchors["dist"], degraded)]
    assert {d.what for d in deltas} >= {claim, "trajectory_max_rel_dev"}
    only = regress.compare("dist", anchors["dist"], degraded,
                           claims_only=True)
    assert {d.what for d in only} == {claim}
    del degraded["claims"][claim]
    assert any("missing" in d.detail
               for d in regress.compare("dist", anchors["dist"], degraded))
    for module, anchor in anchors.items():
        with open(tmp_path / f"BENCH_{module}.json", "w") as fh:
            json.dump(degraded if module == "dist" else anchor, fh)
    assert regress.main(["--check", str(tmp_path),
                         "--anchors", REPO_ROOT]) == 1
    assert "REGRESSION dist/" in capsys.readouterr().out


def test_history_renders_the_committed_trajectory():
    committed = regress.load_history(
        os.path.join(REPO_ROOT, regress.HISTORY_NAME))
    assert {r["module"] for r in committed} >= set(regress.MODULES)
    text = regress.render_history(committed)
    assert "FAILED" not in text
    from repro.obs import regress as jregress
    assert text == jregress.render_history(committed)
