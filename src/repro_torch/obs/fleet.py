"""Fleet observability: one event stream per host, merged into one trace;
the port's copy of ``repro.obs.fleet`` (no JAX there either).

The dist/elastic runtimes historically funneled every host's telemetry
through one process-global :class:`~repro_torch.obs.events.EventRecorder` —
fine for the simulated topology, a dead end for real multi-process SPMD
(one process a host), where each process has its own ``perf_counter`` origin
and its own log file.  This module makes per-host streams first-class:

  * :class:`FleetRecorder` — a *driver* lane (engine stage spans, run
    meta, health events) plus one :class:`EventRecorder` lane per host
    (that host's meter/prefetch traffic, tagged ``host=h``).  Simulated
    hosts may run on deliberately skewed clocks (``skew={h: seconds}``)
    to model per-process clock origins.  ``save(dir)`` writes one JSONL
    per lane.

  * :func:`merge_streams` / :class:`FleetTrace` — the cross-host merger.
    Per-host clocks are aligned at the natural sync points: the
    once-per-stage collective flush, marked in every lane by a
    ``fleet.barrier`` instant (``DistributedBetEngine`` emits it from
    ``_collect_host_records``, the same call that all-gathers the host
    records).  Each lane gets one constant offset (median of its
    per-barrier deltas against the reference lane — robust to one
    straggling stage); residual per-barrier misalignment is the host's
    *lag* (how far behind the reference it reached each flush), and the
    drift of those deltas over the run is its clock *skew*.  The merged
    stream is **causally ordered**: within a host, original emission
    order is preserved exactly; across hosts, no event after a host's
    stage-``k`` barrier precedes any event before another host's
    stage-``k`` barrier (the collective flush is a happens-before edge),
    and within those constraints events sort by aligned time.

Merged traces are written with ``schema_version=2`` (events carry
``t_raw``/``lane_seq``/``skew_s`` columns next to the core schema);
``python -m repro_torch.obs.fleet <dir>`` merges saved per-host logs offline.
"""
from __future__ import annotations

import heapq
import json
import pathlib
import time

from .events import (FLEET_SCHEMA_VERSION, EventRecorder, chrome_trace,
                     read_log, write_jsonl, _json_safe)

#: The per-lane stage-flush sync mark (one per stage per lane).
BARRIER = "fleet.barrier"

#: Lane key for the driver (engine) stream in merges and filenames.
DRIVER = "driver"


class FleetRecorder:
    """Per-host event lanes behind the single-recorder interface.

    The engine (and everything else driver-side) writes through this
    object exactly as through an ``EventRecorder`` — those events land in
    the *driver* lane.  Per-host producers (host meters, lane
    prefetchers) write into ``lane(h)``, their own stream on their own
    clock.  ``barrier(stage, ...)`` stamps the stage-flush sync mark into
    every lane at once — the simulated stand-in for "every process passes
    the collective at this moment"."""

    def __init__(self, hosts=(), *, skew: dict | None = None):
        self.skew = {int(h): float(s) for h, s in (skew or {}).items()}
        self.driver = EventRecorder()
        self.lanes: dict[int, EventRecorder] = {}
        self._listeners: list = []
        for h in hosts:
            self.lane(h)

    def lane(self, host) -> EventRecorder:
        """The (created-on-demand) recorder for one host lane."""
        host = int(host)
        rec = self.lanes.get(host)
        if rec is None:
            off = self.skew.get(host, 0.0)
            clock = (lambda o=off: time.perf_counter() + o) if off else None
            rec = EventRecorder(clock=clock)
            rec.set_context(host=host)
            for fn in self._listeners:
                rec.add_listener(fn)
            self.lanes[host] = rec
        return rec

    # ------------------------------------------- recorder-protocol delegation
    def instant(self, name, **kw):
        return self.driver.instant(name, **kw)

    def counter(self, name, **kw):
        return self.driver.counter(name, **kw)

    def span(self, name, **kw):
        return self.driver.span(name, **kw)

    def set_context(self, **tags):
        self.driver.set_context(**tags)

    def clear_context(self, *keys):
        self.driver.clear_context(*keys)

    def events(self):
        return self.driver.events()

    def event_dicts(self):
        return self.driver.event_dicts()

    def __len__(self):
        return len(self.driver)

    def add_listener(self, fn) -> None:
        """Tap every lane (driver + hosts, including lanes created later)."""
        self._listeners.append(fn)
        self.driver.add_listener(fn)
        for rec in self.lanes.values():
            rec.add_listener(fn)

    # ----------------------------------------------------------------- sync
    def barrier(self, *, stage: int, n_t: int | None = None) -> None:
        """Stamp the once-per-stage collective-flush sync mark into every
        lane (and the driver, which anchors the reference timeline)."""
        fields = {"stage": int(stage)}
        if n_t is not None:
            fields["n_t"] = int(n_t)
        self.driver.instant(BARRIER, tags={"host": DRIVER}, **fields)
        for rec in self.lanes.values():
            rec.instant(BARRIER, **fields)

    # ---------------------------------------------------------------- sinks
    def streams(self) -> dict:
        """All lanes as ``{key: [event_dict, ...]}`` (driver + hosts)."""
        out = {DRIVER: self.driver.event_dicts()}
        for h in sorted(self.lanes):
            out[h] = self.lanes[h].event_dicts()
        return out

    def save(self, directory) -> dict:
        """One JSONL per lane under ``directory``: ``events_driver.jsonl``
        plus ``events_host<h>.jsonl``; returns ``{lane: path}``."""
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        paths = {DRIVER: str(d / "events_driver.jsonl")}
        write_jsonl(paths[DRIVER], self.driver.event_dicts())
        for h in sorted(self.lanes):
            paths[h] = str(d / f"events_host{h}.jsonl")
            write_jsonl(paths[h], self.lanes[h].event_dicts())
        return paths

    def merged(self) -> "FleetTrace":
        """Merge all lanes into one causally-ordered :class:`FleetTrace`."""
        return merge_streams(self.streams())


# ------------------------------------------------------------------- merger
def _barrier_times(stream: list[dict]) -> dict[int, float]:
    return {e["fields"]["stage"]: e["t"] for e in stream
            if e["name"] == BARRIER}


def _median(vals: list[float]) -> float:
    vals = sorted(vals)
    m = len(vals) // 2
    return vals[m] if len(vals) % 2 else 0.5 * (vals[m - 1] + vals[m])


def merge_streams(streams: dict, *, reference=None) -> "FleetTrace":
    """Merge per-lane event streams into one causally-ordered trace.

    ``streams`` maps lane key (``"driver"`` or a host id) to that lane's
    event dicts in emission order.  The reference lane (default: the
    driver if present, else the smallest key) keeps its clock; every
    other lane is shifted by one constant offset — the median of
    ``t_ref(barrier) - t_lane(barrier)`` over the stage barriers the two
    lanes share — which aligns the streams at the stage flushes without
    bending any lane's internal timing.  Lanes without common barriers
    (or a merge with no barriers at all) fall back to offset 0.
    """
    keys = list(streams)
    if not keys:
        return FleetTrace([], {})
    if reference is None:
        reference = DRIVER if DRIVER in streams else sorted(
            keys, key=str)[0]
    ref_sync = _barrier_times(streams[reference])
    offsets: dict = {}
    lags: dict = {}
    for key, stream in streams.items():
        sync = _barrier_times(stream)
        common = sorted(set(sync) & set(ref_sync))
        deltas = {s: ref_sync[s] - sync[s] for s in common}
        off = _median(list(deltas.values())) if deltas else 0.0
        offsets[key] = off
        # residual misalignment after the constant shift: how far behind
        # (positive) the reference this lane reached each stage flush
        lags[key] = {s: (sync[s] + off) - ref_sync[s] for s in common}

    # causal segment merge: lane events are split at their barriers; all
    # of segment k (everything up to and including barrier k) drains from
    # every lane before any lane's segment k+1 starts, so the collective
    # flush stays a happens-before edge in the merged order.  Within a
    # segment, a k-way heap merge by aligned time (never reordering
    # within a lane).
    stages = sorted({s for key in keys for s in _barrier_times(streams[key])})
    segmented: dict = {}
    for key, stream in streams.items():
        segs: list[list[dict]] = [[] for _ in range(len(stages) + 1)]
        seg = 0
        for e in stream:
            segs[seg].append(e)
            if e["name"] == BARRIER:
                seg = stages.index(e["fields"]["stage"]) + 1
        segmented[key] = segs

    merged: list[dict] = []
    order = {k: i for i, k in enumerate(sorted(keys, key=str))}
    for seg in range(len(stages) + 1):
        heap = []
        for key in keys:
            events = segmented[key][seg]
            if events:
                t = events[0]["t"] + offsets[key]
                heapq.heappush(heap, (t, order[key], 0, key, events))
        while heap:
            t, okey, i, key, events = heapq.heappop(heap)
            e = dict(events[i])
            e["t_raw"] = e["t"]
            e["lane_seq"] = e["seq"]
            e["lane"] = key
            e["t"] = t
            e["skew_s"] = offsets[key]
            # an explicit host tag wins (a driver-side health detection
            # *about* host 2 stays attributed to host 2); untagged events
            # inherit their lane
            tags = dict(e.get("tags") or {})
            tags.setdefault("host", key)
            e["tags"] = tags
            e["seq"] = len(merged)
            merged.append(e)
            if i + 1 < len(events):
                heapq.heappush(heap, (events[i + 1]["t"] + offsets[key],
                                      okey, i + 1, key, events))

    hosts = {}
    for key in keys:
        lag = lags[key]
        hosts[key] = {
            "events": len(streams[key]),
            "offset_s": offsets[key],
            "lag_s": {str(s): lag[s] for s in sorted(lag)},
            "max_lag_s": max(lag.values(), default=0.0),
            "drift_s": (max(lag.values()) - min(lag.values())) if lag
            else 0.0,
        }
    return FleetTrace(merged, hosts, reference=reference)


class FleetTrace:
    """One merged, causally-ordered fleet event stream.

    ``events`` follow the core schema (re-``seq``'d over the merge) plus
    the fleet columns: ``t`` is the *aligned* time, ``t_raw`` the lane's
    own clock, ``lane`` the source lane, ``lane_seq`` the original
    per-lane order, ``skew_s`` the constant clock offset applied to the
    lane.  ``hosts`` summarizes each lane's alignment: offset, per-stage
    lag behind the reference at the flush barriers, and drift."""

    def __init__(self, events: list[dict], hosts: dict, *,
                 reference=DRIVER):
        self.events = events
        self.hosts = hosts
        self.reference = reference

    def __len__(self) -> int:
        return len(self.events)

    def host_events(self, key) -> list[dict]:
        return [e for e in self.events if e["tags"].get("host") == key]

    def summary(self) -> dict:
        return {"schema_version": FLEET_SCHEMA_VERSION,
                "reference": self.reference,
                "events": len(self.events),
                "hosts": {str(k): v for k, v in sorted(
                    self.hosts.items(), key=lambda kv: str(kv[0]))}}

    def to_jsonl(self, path) -> int:
        return write_jsonl(path, self.events,
                           schema_version=FLEET_SCHEMA_VERSION)

    def to_chrome_trace(self, path) -> int:
        out = chrome_trace(self.events)
        with open(path, "w") as fh:
            json.dump(out, fh, default=_json_safe)
        return len(out["traceEvents"])


# ---------------------------------------------------------------------- CLI
def _lane_key(path: pathlib.Path):
    stem = path.stem            # events_driver | events_host3 | anything
    if stem.endswith(DRIVER):
        return DRIVER
    digits = "".join(c for c in stem if c.isdigit())
    return int(digits) if digits else stem


def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.obs.fleet <dir-or-logs...>`` — merge saved
    per-host JSONL streams into one fleet trace."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Merge per-host observability streams into one "
                    "causally-ordered fleet trace")
    ap.add_argument("paths", nargs="+",
                    help="a directory of events_*.jsonl lanes, or the "
                         "lane files themselves")
    ap.add_argument("--out", default=None, help="merged JSONL path")
    ap.add_argument("--chrome", default=None,
                    help="also write a Chrome trace of the merge")
    args = ap.parse_args(argv)
    files: list[pathlib.Path] = []
    for p in map(pathlib.Path, args.paths):
        files.extend(sorted(p.glob("events_*.jsonl")) if p.is_dir() else [p])
    if not files:
        print("no event logs found")
        return 1
    streams = {_lane_key(p): read_log(p)[1] for p in files}
    trace = merge_streams(streams)
    print(json.dumps(trace.summary(), indent=2, default=_json_safe))
    if args.out:
        trace.to_jsonl(args.out)
        print(f"merged {len(trace)} events -> {args.out}")
    if args.chrome:
        trace.to_chrome_trace(args.chrome)
        print(f"chrome trace -> {args.chrome}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
