"""Structured spans and events — the one telemetry stream for the BET stack;
the port's copy of ``repro.obs.events`` (no JAX there either).

BET's claims are *accounting* claims (Thm 4.1's O(1/ε) data accesses, §3.3's
load/compute overlap, ≤ 1 host transfer per stage), yet the instrumentation
backing them has historically lived on five ad-hoc surfaces: trace points,
``SimulatedClock`` charges, ``DataAccessMeter`` counters,
``trace.meta["elastic_events"]`` and the serve loop's private wall-clock
report.  ``EventRecorder`` is the single structured sink they all feed:

  * **spans** — a named interval with a monotonic start (``time.perf_counter``)
    and a duration (stage compute, collective flush, checkpoint publish,
    serving ticks),
  * **instants** — a point event (a shard landing, an expansion decision, an
    elastic fault, a hot swap),
  * **counters** — a sampled numeric state (the per-stage clock totals).

Every event carries ``tags`` (stage / host / lane context — recorder-level
context set at stage boundaries merges into each event) and free-form
JSON-safe ``fields``.  Emission is thread-safe (the prefetcher's background
workers emit from their own threads) and totally ordered by ``seq``.

Sinks: ``to_jsonl`` writes one JSON object per line (the schema below;
``python -m repro_torch.obs.events <path>`` validates it), and
``to_chrome_trace`` writes the Chrome ``trace_event`` JSON that Perfetto
(https://ui.perfetto.dev) renders as a timeline — spans become complete
("X") slices, instants thread-scoped marks, counters counter tracks; the
``host`` tag maps to the process lane.

Recording is allocation-light but not free: the stack only emits when a
recorder is wired (the serve loop always wires one); every hook is a
``None`` check otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Iterable

KINDS = ("span", "instant", "counter")

#: JSONL log versions: 1 — one recorder's stream; 2 — a merged fleet trace
#: (per-host streams aligned at stage-flush barriers; events additionally
#: carry ``t_raw``/``lane_seq``/``skew_s`` columns).  Logs open with a
#: ``{"schema_version": N}`` header record; headerless logs are legacy v1.
SCHEMA_VERSION = 1
FLEET_SCHEMA_VERSION = 2
KNOWN_SCHEMA_VERSIONS = (SCHEMA_VERSION, FLEET_SCHEMA_VERSION)

#: The JSONL schema ``validate_events`` enforces (one object per line).
SCHEMA = {
    "name": "str — event name, dot-namespaced (e.g. 'stage.compute')",
    "kind": f"str — one of {KINDS}",
    "t": "float — time.perf_counter() at the event (span: at its start)",
    "dur": "float|None — span duration in seconds (None for non-spans)",
    "tags": "dict — context labels (stage/host/lane/...)",
    "fields": "dict — JSON-safe event payload",
    "seq": "int — total emission order (unique, strictly increasing)",
    "thread": "str — emitting thread name",
}


@dataclasses.dataclass
class Event:
    """One telemetry record (see ``SCHEMA``)."""
    name: str
    kind: str
    t: float
    dur: float | None
    tags: dict
    fields: dict
    seq: int
    thread: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class EventRecorder:
    """Thread-safe structured event sink with span/instant/counter emission.

    ``set_context(stage=3)`` merges into every subsequent event's tags until
    cleared — the engine sets the stage there once per boundary instead of
    threading it through every call site.  Explicit per-event ``tags``
    override the context.

    ``clock`` overrides the timestamp source (default
    ``time.perf_counter``) — a simulated host lane runs on its own skewed
    clock, exactly like a real per-process ``perf_counter`` with an
    arbitrary origin; the fleet merger re-aligns those at stage barriers.

    ``add_listener(fn)`` registers a live tap: ``fn(event_dict)`` is called
    on every emission, after the event lands (outside the lock, so a
    listener may itself emit — the health detectors do)."""

    def __init__(self, *, clock=None):
        self._lock = threading.Lock()
        self._events: list[Event] = []
        self._context: dict = {}
        self._seq = 0
        self._now = clock if clock is not None else time.perf_counter
        self._listeners: list = []

    # ------------------------------------------------------------- emission
    def _emit(self, name: str, kind: str, t: float, dur: float | None,
              tags: dict | None, fields: dict) -> Event:
        with self._lock:
            ev = Event(name=str(name), kind=kind, t=float(t),
                       dur=None if dur is None else float(dur),
                       tags={**self._context, **(tags or {})},
                       fields=fields, seq=self._seq,
                       thread=threading.current_thread().name)
            self._seq += 1
            self._events.append(ev)
            listeners = list(self._listeners)
        if listeners:
            d = ev.to_dict()
            for fn in listeners:
                fn(d)
        return ev

    def instant(self, name: str, *, tags: dict | None = None,
                fields: dict | None = None, **kw) -> Event:
        # explicit ``fields=`` admits payload keys that collide with the
        # signature (a field literally called "name", as run.meta carries)
        return self._emit(name, "instant", self._now(), None,
                          tags, {**(fields or {}), **kw})

    def counter(self, name: str, *, tags: dict | None = None,
                fields: dict | None = None, **kw) -> Event:
        return self._emit(name, "counter", self._now(), None,
                          tags, {**(fields or {}), **kw})

    @contextlib.contextmanager
    def span(self, name: str, *, tags: dict | None = None, **fields):
        """Time a block; emits ONE complete event at exit (start + dur), so
        begin/end pairing can never be broken by an exception.  The yielded
        dict collects extra fields discovered inside the block."""
        extra: dict = {}
        t0 = self._now()
        try:
            yield extra
        finally:
            self._emit(name, "span", t0, self._now() - t0,
                       tags, {**fields, **extra})

    def add_listener(self, fn) -> None:
        """Register a live event tap (``fn(event_dict)`` per emission)."""
        with self._lock:
            self._listeners.append(fn)

    # -------------------------------------------------------------- context
    def set_context(self, **tags) -> None:
        with self._lock:
            self._context.update(tags)

    def clear_context(self, *keys) -> None:
        with self._lock:
            if keys:
                for k in keys:
                    self._context.pop(k, None)
            else:
                self._context.clear()

    # ---------------------------------------------------------------- reads
    def events(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def event_dicts(self) -> list[dict]:
        return [e.to_dict() for e in self.events()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # ---------------------------------------------------------------- sinks
    def to_jsonl(self, path) -> int:
        """One JSON object per line (``SCHEMA``) behind a
        ``{"schema_version": 1}`` header record; returns the event count
        (header excluded)."""
        return write_jsonl(path, self.event_dicts())

    def to_chrome_trace(self, path) -> int:
        """Chrome ``trace_event`` JSON, viewable in Perfetto.  The ``host``
        tag becomes the pid lane; each emitting thread gets a tid."""
        out = chrome_trace(self.event_dicts())
        with open(path, "w") as fh:
            json.dump(out, fh, default=_json_safe)
        return len(out["traceEvents"])


def _json_safe(v):
    """Last-resort JSON fallback (numpy scalars and the like)."""
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(v)


# ------------------------------------------------------------- chrome export
def _host_pids(events: list[dict]) -> dict:
    """Stable ``host`` tag -> Chrome pid lane.  Int hosts keep their value;
    every other distinct tag (``"driver"``, a hostname string, a missing
    tag) gets its own lane above the int range — non-int hosts used to all
    collapse into pid 0 and merge in Perfetto."""
    seen: list = []
    for e in events:
        h = (e.get("tags") or {}).get("host")
        if h not in seen:
            seen.append(h)
    pids: dict = {h: h for h in seen
                  if isinstance(h, int) and not isinstance(h, bool)}
    next_pid = max(pids.values(), default=-1) + 1
    for h in seen:
        if h not in pids:
            pids[h] = next_pid
            next_pid += 1
    return pids


def chrome_trace(events: Iterable[dict]) -> dict:
    """Event dicts -> a Chrome ``trace_event`` document (Perfetto-loadable).
    Each distinct ``host`` tag is its own pid lane, named by a
    ``process_name`` metadata row."""
    events = list(events)
    pids = _host_pids(events)
    tids: dict[str, int] = {}
    trace: list[dict] = []
    for h, pid in pids.items():
        name = "driver" if h is None else f"host {h}"
        trace.append({"name": "process_name", "ph": "M", "pid": pid,
                      "tid": 0, "args": {"name": name}})
    for e in events:
        tags = e.get("tags") or {}
        pid = pids[tags.get("host")]
        thread = e.get("thread", "main")
        if thread not in tids:
            tids[thread] = len(tids)
            for p in set(pids.values()):
                trace.append({"name": "thread_name", "ph": "M", "pid": p,
                              "tid": tids[thread],
                              "args": {"name": thread}})
        args = {**tags, **(e.get("fields") or {})}
        row = {"name": e["name"], "ts": e["t"] * 1e6, "pid": pid,
               "tid": tids[thread]}
        if e["kind"] == "span":
            row.update(ph="X", dur=(e.get("dur") or 0.0) * 1e6, args=args)
        elif e["kind"] == "counter":
            row.update(ph="C", args={k: v for k, v in args.items()
                                     if isinstance(v, (int, float))
                                     and not isinstance(v, bool)})
        else:
            row.update(ph="i", s="t", args=args)
        trace.append(row)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------- jsonl io
def write_jsonl(path, events: list[dict], *,
                schema_version: int = SCHEMA_VERSION) -> int:
    """Write a versioned JSONL event log: one ``{"schema_version": N}``
    header record, then one event object per line."""
    with open(path, "w") as fh:
        fh.write(json.dumps({"schema_version": int(schema_version)}) + "\n")
        for e in events:
            fh.write(json.dumps(e, default=_json_safe) + "\n")
    return len(events)


def read_log(path) -> tuple[int | None, list[dict]]:
    """Load a JSONL event log as ``(schema_version, events)``.  A leading
    ``{"schema_version": N}`` record is the version header; logs without
    one are legacy streams (version ``None``, treated as v1)."""
    version = None
    out: list[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if not out and version is None and isinstance(rec, dict) \
                    and "schema_version" in rec and "name" not in rec:
                version = rec["schema_version"]
                continue
            out.append(rec)
    return version, out


def from_jsonl(path) -> list[dict]:
    """Load an ``EventRecorder.to_jsonl`` log back into event dicts (the
    version header, when present, is stripped)."""
    return read_log(path)[1]


def validate_events(events: Iterable[dict]) -> list[str]:
    """Schema errors in an event stream ([] = valid).  Checks each record's
    shape against ``SCHEMA`` plus the stream invariants (unique strictly
    increasing ``seq``, non-negative span durations)."""
    errors: list[str] = []
    last_seq = None
    for i, e in enumerate(events):
        where = f"event {i}"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        missing = [k for k in SCHEMA if k not in e]
        if missing:
            errors.append(f"{where}: missing keys {missing}")
            continue
        if not isinstance(e["name"], str) or not e["name"]:
            errors.append(f"{where}: bad name {e['name']!r}")
        if e["kind"] not in KINDS:
            errors.append(f"{where}: bad kind {e['kind']!r}")
        if not isinstance(e["t"], (int, float)):
            errors.append(f"{where}: bad t {e['t']!r}")
        if e["kind"] == "span":
            if not isinstance(e["dur"], (int, float)) or e["dur"] < 0:
                errors.append(f"{where}: span needs dur >= 0, "
                              f"got {e['dur']!r}")
        elif e["dur"] is not None:
            errors.append(f"{where}: non-span carries dur {e['dur']!r}")
        if not isinstance(e["tags"], dict) or not isinstance(e["fields"],
                                                             dict):
            errors.append(f"{where}: tags/fields must be objects")
        if not isinstance(e["seq"], int) or isinstance(e["seq"], bool):
            errors.append(f"{where}: bad seq {e['seq']!r}")
        elif last_seq is not None and e["seq"] <= last_seq:
            errors.append(f"{where}: seq {e['seq']} not increasing "
                          f"(previous {last_seq})")
        else:
            last_seq = e["seq"]
        if not isinstance(e["thread"], str):
            errors.append(f"{where}: bad thread {e['thread']!r}")
    return errors


def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.obs.events <events.jsonl>`` — CI schema gate."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate an observability JSONL event log")
    ap.add_argument("path", help="events.jsonl written by EventRecorder")
    args = ap.parse_args(argv)
    version, events = read_log(args.path)
    if version is not None and version not in KNOWN_SCHEMA_VERSIONS:
        print(f"INVALID: unknown schema_version {version!r} "
              f"(known: {KNOWN_SCHEMA_VERSIONS})")
        return 1
    errors = validate_events(events)
    if errors:
        for err in errors[:50]:
            print(f"INVALID: {err}")
        print(f"{args.path}: {len(errors)} schema error(s) "
              f"in {len(events)} events")
        return 1
    kinds: dict[str, int] = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    label = "legacy" if version is None else f"v{version}"
    print(f"{args.path}: {len(events)} events valid ({label}) "
          + " ".join(f"{k}={v}" for k, v in sorted(kinds.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
