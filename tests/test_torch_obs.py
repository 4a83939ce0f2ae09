"""The telemetry core in the port, on the CPU: ``repro_torch.obs`` (the
port's copies of the reference's ``events``, ``metrics`` and ``report``)
— the recorder's semantics under threads, JSONL and Chrome round trips,
schema validation, the ``attach_*`` adapters' idempotence, the
prefetcher's cross-thread event order, ``serve_summary``'s all-None edge
— and the engine's emission hooks: the reference's event vocabulary per
stage, a RunReport that re-derives the live meters, and a run with no
recorder (or with one) bit for bit the run as it was."""
from __future__ import annotations

import collections
import json
import threading

import numpy as np
import pytest
import torch

import repro.api as R
from repro_torch import api as P
from repro_torch.api import make_store
from repro_torch.core.timemodel import SimulatedClock
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.shards import DataAccessMeter
from repro_torch.obs import (EventRecorder, MetricsRegistry, RunReport,
                             chrome_trace, from_jsonl, validate_events)
from repro_torch.obs import events as ev
from repro_torch.obs.metrics import (attach_clock, attach_dataset,
                                     attach_meter, attach_prefetcher,
                                     attach_server)

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

DATA = dict(dataset="w8a_like", scale=0.02, plane="plane", shard_size=32)
FIXED = ("fixed_steps", {"inner_steps": 2, "final_steps": 3})
OPT = ("newton_cg", {"hessian_fraction": 1.0})


def _spec(pkg, policy=FIXED, **kw):
    base = dict(data=pkg.DataSpec(**DATA), policy=pkg.PolicySpec(*policy),
                optimizer=pkg.OptimizerSpec(*OPT),
                schedule=pkg.ScheduleSpec(n0=32))
    base.update(kw)
    return pkg.RunSpec(**base)


def _observed_session(spec):
    """A port session with the engine, the plane and the clock wired to
    one recorder, as the reference's ``ObsSpec(enabled=True)`` wires
    them."""
    sess = P.build(spec, device="cpu")
    rec = EventRecorder()
    sess.engine.recorder = rec
    attach_dataset(sess.dataset, rec)
    attach_clock(sess.clock, rec)
    return sess, rec


# --------------------------------------------------------------- recorder
def test_recorder_context_spans_and_jsonl_roundtrip(tmp_path):
    rec = EventRecorder()
    rec.set_context(stage=3)
    rec.instant("a", x=1)
    with rec.span("b", window=64) as extra:
        extra["steps"] = 5
    rec.counter("c", tags={"stage": 9}, v=2.5)
    rec.clear_context("stage")
    rec.instant("d", fields={"name": "collides-with-kwarg"})
    evs = rec.event_dicts()
    assert [e["name"] for e in evs] == ["a", "b", "c", "d"]
    assert evs[0]["tags"] == {"stage": 3}
    assert evs[1]["kind"] == "span" and evs[1]["dur"] >= 0
    assert evs[1]["fields"] == {"window": 64, "steps": 5}
    assert evs[2]["tags"] == {"stage": 9}      # explicit tags win
    assert evs[3]["tags"] == {} and evs[3]["fields"]["name"].startswith("col")
    assert [e["seq"] for e in evs] == [0, 1, 2, 3]
    assert validate_events(evs) == []
    path = tmp_path / "events.jsonl"
    assert rec.to_jsonl(path) == 4
    assert from_jsonl(path) == evs
    assert ev.main([str(path)]) == 0


def test_recorder_span_emits_even_on_exception():
    rec = EventRecorder()
    with pytest.raises(ValueError):
        with rec.span("boom"):
            raise ValueError("x")
    (e,) = rec.event_dicts()
    assert e["name"] == "boom" and e["kind"] == "span" and e["dur"] >= 0


def test_recorder_orders_events_across_threads_and_exports_chrome():
    """Eight threads emitting at once: every event lands once, ``seq`` is
    a total order, and each thread's own events keep their order."""
    rec = EventRecorder()

    def emit(i):
        for j in range(100):
            rec.instant("t", worker=i, j=j)

    threads = [threading.Thread(target=emit, args=(i,), name=f"w{i}")
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    evs = rec.event_dicts()
    assert len(evs) == 800
    assert [e["seq"] for e in evs] == list(range(800))   # total order
    for i in range(8):
        mine = [e for e in evs if e["fields"]["worker"] == i]
        assert [e["fields"]["j"] for e in mine] == list(range(100))
        assert {e["thread"] for e in mine} == {f"w{i}"}
    assert validate_events(evs) == []
    rec2 = EventRecorder()
    with rec2.span("s", tags={"host": 1}):
        pass
    rec2.counter("c", n=3, label="dropped-from-counter-track")
    rec2.instant("i")
    doc = chrome_trace(rec2.event_dicts())
    rows = {r["name"]: r for r in doc["traceEvents"] if r.get("ph") != "M"}
    assert rows["s"]["ph"] == "X" and rows["s"]["pid"] == 1
    assert rows["s"]["dur"] >= 0
    assert rows["c"]["ph"] == "C" and rows["c"]["args"] == {"n": 3}
    assert rows["i"]["ph"] == "i"
    assert any(r.get("ph") == "M" for r in doc["traceEvents"])


def test_chrome_trace_file_round_trip(tmp_path):
    rec = EventRecorder()
    rec.instant("a", tags={"host": 1})
    rec.instant("b", tags={"host": "driver"})
    rec.instant("c")
    path = tmp_path / "trace.json"
    n = rec.to_chrome_trace(path)
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == n
    assert doc == json.loads(json.dumps(chrome_trace(rec.event_dicts())))
    rows = {r["name"]: r for r in doc["traceEvents"] if r.get("ph") != "M"}
    assert len({rows[k]["pid"] for k in "abc"}) == 3


def test_jsonl_schema_version_header_roundtrip(tmp_path, capsys):
    rec = EventRecorder()
    rec.instant("a", x=1)
    path = tmp_path / "events.jsonl"
    assert rec.to_jsonl(path) == 1              # header excluded from count
    first = json.loads(path.read_text().splitlines()[0])
    assert first == {"schema_version": ev.SCHEMA_VERSION}
    version, events = ev.read_log(path)
    assert version == ev.SCHEMA_VERSION
    assert events == rec.event_dicts()          # header stripped on read
    assert ev.main([str(path)]) == 0
    assert f"(v{ev.SCHEMA_VERSION})" in capsys.readouterr().out
    legacy = tmp_path / "legacy.jsonl"
    legacy.write_text("\n".join(json.dumps(e)
                                for e in rec.event_dicts()) + "\n")
    assert ev.read_log(legacy) == (None, rec.event_dicts())
    assert ev.main([str(legacy)]) == 0
    assert "(legacy)" in capsys.readouterr().out
    future = tmp_path / "future.jsonl"
    future.write_text(json.dumps({"schema_version": 99}) + "\n"
                      + json.dumps(rec.event_dicts()[0]) + "\n")
    assert ev.main([str(future)]) == 1
    assert "unknown schema_version" in capsys.readouterr().out


def test_validate_events_flags_malformed(tmp_path, capsys):
    ok = {"name": "a", "kind": "instant", "t": 0.0, "dur": None,
          "tags": {}, "fields": {}, "seq": 0, "thread": "m"}
    bad = [
        {**ok, "kind": "bogus", "seq": 1},
        {**ok, "dur": 1.0, "seq": 2},               # non-span carries dur
        {**ok, "seq": 2},                           # seq not increasing
        {k: v for k, v in ok.items() if k != "tags"},
    ]
    errors = validate_events([ok] + bad)
    assert len(errors) == 4
    assert any("bad kind" in e for e in errors)
    assert any("carries dur" in e for e in errors)
    assert any("not increasing" in e for e in errors)
    assert any("missing keys" in e for e in errors)
    path = tmp_path / "bad.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in [ok] + bad) + "\n")
    assert ev.main([str(path)]) == 1
    assert "INVALID:" in capsys.readouterr().out


# ----------------------------------------------------------- metric adapters
def test_attach_meter_and_clock_mirror_every_update():
    rec = EventRecorder()
    meter = attach_meter(DataAccessMeter(), rec, host=0)
    meter.record_load(nbytes=100, examples=4, duration_s=0.5, blocked_s=0.1,
                      prefetched=True)
    meter.record_upload(nbytes=100, examples=4)
    meter.record_access(40)
    clock = attach_clock(SimulatedClock(p=10.0, a=1.0, s=5.0), rec)
    clock.batch_update(8)
    rr = RunReport.from_recorder(rec)
    assert rr.matches_meter(meter.snapshot()), \
        rr.meter_mismatches(meter.snapshot())
    charge = rr.named("clock.charge")[0]["fields"]
    assert charge["op"] == "batch_update" and charge["n"] == 8
    assert charge["time"] == clock.time
    reg = MetricsRegistry.from_events(rec.event_dicts())
    snap = reg.snapshot()
    assert snap["counters"]["meter.load.nbytes"] == 100
    assert snap["counters"]["meter.access.examples"] == 40


def test_attach_adapters_are_idempotent_and_snapshot_safe():
    rec = EventRecorder()
    meter = DataAccessMeter()
    attach_meter(meter, rec)
    attach_meter(meter, rec)                # second attach must not stack
    meter.record_access(7)
    assert len([e for e in rec.event_dicts()
                if e["name"] == "meter.access"]) == 1
    snap = meter.snapshot()
    assert set(snap) >= {"examples_accessed", "overlap_fraction"}
    fresh = DataAccessMeter()
    fresh.restore(snap)
    assert fresh.examples_accessed == 7
    clock = SimulatedClock()
    attach_clock(clock, rec)
    attach_clock(clock, rec)
    clock.eval_pass(3)
    assert len(RunReport.from_recorder(rec).named("clock.charge")) == 1

    class _Server:                          # BetServer's adopt contract
        swap_count, swap_latencies_s = 0, []

        def adopt(self, stage, params, *, t_detect=None):
            self.swap_count += 1
            self.swap_latencies_s.append(0.5)
            return True
    srv = _Server()
    attach_server(srv, rec)
    attach_server(srv, rec)
    assert srv.adopt(4, None)
    (swap,) = RunReport.from_recorder(rec).named("serve.swap")
    assert swap["fields"] == {"stage": 4, "latency_s": 0.5, "swap_count": 1}


# --------------------------------------------------- prefetcher event order
def test_prefetcher_events_ordered_across_threads():
    arr = np.arange(64, dtype=np.float32)[:, None] * np.ones((1, 4),
                                                             np.float32)
    store = make_store("memory", arr, 8, delay_s=0.002)
    rec = EventRecorder()
    pf = Prefetcher([store], DataAccessMeter())
    attach_prefetcher(pf, rec, host=0)
    with pf:
        pf.schedule([0, 1, 2])
        dropped = pf.cancel([2])
        for i in (0, 1, 3):                  # 3 is a cold demand load
            pf.take(i)
    assert dropped == [2]
    evs = rec.event_dicts()
    assert all(e["tags"] == {"host": 0} for e in evs)
    depths = [e for e in evs if e["name"] == "prefetch.depth"]
    assert depths and all(
        {"inflight", "backlog"} <= set(e["fields"]) for e in depths)
    by_shard: dict = {}
    for e in evs:
        if e["name"] == "prefetch.depth":
            continue
        by_shard.setdefault(e["fields"]["shard"], {})[e["name"]] = e
    for shard in (0, 1, 3):
        seen = by_shard[shard]
        # scheduled (driver) < loaded (worker thread) < landed (driver)
        if shard != 3:
            assert seen["prefetch.scheduled"]["seq"] \
                < seen["prefetch.loaded"]["seq"] \
                < seen["prefetch.landed"]["seq"]
        assert seen["prefetch.loaded"]["thread"].startswith("bet-prefetch")
        assert not seen["prefetch.landed"]["thread"].startswith("bet-pref")
        assert seen["prefetch.landed"]["fields"]["prefetched"] == (shard != 3)
    assert "prefetch.landed" not in by_shard.get(2, {})
    assert "prefetch.cancelled" in by_shard[2]
    assert validate_events(evs) == []


# ------------------------------------------------------------ serve summary
def test_serve_summary_with_all_none_staleness_samples():
    rec = EventRecorder()
    assert RunReport.from_recorder(rec).serve_summary() is None
    with rec.span("serve.tick", tick=1):
        rec.instant("serve.ingest", examples=8)
        rec.instant("serve.staleness", staleness=None)
        rec.instant("serve.staleness", staleness=None)
    s = RunReport.from_recorder(rec).serve_summary()
    assert s["staleness_samples"] == [None, None]
    assert s["max_staleness"] == 0
    assert s["ticks"] == 1 and s["ingested_examples"] == 8
    rec.instant("serve.staleness", staleness=2)
    assert RunReport.from_recorder(rec).serve_summary()[
        "max_staleness"] == 2


# ------------------------------------------------------- engine emission
def _per_stage_names(events, skip=("prefetch.", "meter.", "clock.", "run.")):
    """Counter of (event name, stage) over the engine's own events (the
    reference's ``run.meta`` comes from its Session's ObsSpec wiring,
    which the observability slice brings)."""
    out = collections.Counter()
    for e in events:
        if e["name"].startswith(skip):
            continue
        stage = (e.get("tags") or {}).get("stage")
        out[(e["name"], stage)] += 1
    return out


def test_engine_events_match_the_references_vocabulary(tmp_path):
    """A fixed_steps convex run on the plane: the port's engine emits the
    reference's events, stage for stage and as many of each; the report's
    meters equal the live meter, its stage rows the reference's, and one
    transfer a stage; the JSONL alone reproduces the report."""
    jsess = R.build(_spec(R, obs=R.ObsSpec(enabled=True)))
    jsess.run()
    want = jsess.recorder.event_dicts()
    sess, rec = _observed_session(_spec(P))
    tr = sess.run()
    got = rec.event_dicts()
    assert _per_stage_names(got) == _per_stage_names(want)
    assert validate_events(got) == []
    rr = RunReport.from_recorder(rec)
    snap = sess.meters["data_plane"]
    assert rr.matches_meter(snap), rr.meter_mismatches(snap)
    rows = rr.stage_rows()
    assert len(rows) == tr.meta["stages"]
    assert sum(r["steps"] for r in rows) == len(tr.points)
    assert sum(r["clock_accesses"] for r in rows) == sess.clock.data_accesses
    assert rr.claims()["le_one_transfer_per_stage"]
    jrows = RunReport.from_recorder(jsess.recorder).stage_rows()
    for r, j in zip(rows, jrows):
        for k in ("stage", "window", "steps", "transfers", "clock_time",
                  "clock_accesses", "clock_loaded", "examples_loaded",
                  "examples_uploaded"):
            assert r[k] == j[k], k
    assert [d["expand"] for d in rr.expansions()] == \
        [d["expand"] for d in RunReport.from_recorder(
            jsess.recorder).expansions()]
    path = tmp_path / "events.jsonl"
    rec.to_jsonl(path)
    assert RunReport.from_jsonl(path).to_dict() == rr.to_dict()


@pytest.mark.parametrize("policy", [
    FIXED, ("two_track", {"final_steps": 3})], ids=["fixed_steps",
                                                    "two_track"])
def test_engine_without_a_recorder_runs_bitwise_as_before(policy):
    """The same run three ways — no recorder (the engine as it was), no
    recorder again, and fully observed — gives the same trace bit for
    bit (every column, the transfers, the final w)."""
    def trace(observed):
        spec = _spec(P, policy=policy)
        if observed:
            sess, rec = _observed_session(spec)
        else:
            sess, rec = P.build(spec, device="cpu"), None
            assert sess.engine.recorder is None
        tr = sess.run()
        return tr, rec
    plain, _ = trace(False)
    again, _ = trace(False)
    seen, rec = trace(True)
    for other in (again, seen):
        for col in ("f_window", "f_full", "time", "accesses", "window"):
            assert other.column(col) == plain.column(col), col
        assert other.meta["host_transfers"] == plain.meta["host_transfers"]
        assert torch.equal(other.params, plain.params)
    transfers = RunReport.from_recorder(rec).named("engine.transfer")
    assert len(transfers) == plain.meta["host_transfers"]
    assert {e["name"] for e in rec.event_dicts()} >= {
        "stage.begin", "stage.acquire", "stage.compute", "expand.decision",
        "stage.flush", "stage.totals", "stage.end"}
