"""Live health detectors over the event stream + the end-of-run report;
the port's copy of ``repro.obs.health`` (no JAX there either).

``RunReport`` is a post-mortem: it recomputes the BENCH claims after the
run.  The detectors here run *while the run is live* — a
:class:`HealthMonitor` taps the recorder (``add_listener``) and feeds
every emission through a set of streaming detectors:

  ===========================  ==========================================
  detector                     fires when
  ===========================  ==========================================
  ``straggler``                one host's recent shard-load pace exceeds
                               ``ratio``× the median of the other hosts'
                               (per-host ``meter.load`` durations — the
                               signal a ``FaultPlan`` ``slow@`` injection
                               or a genuinely sick host produces)
  ``expansion_stall``          a ``TrafficDriven`` policy's consecutive
                               holds reach ``hold_frac`` of
                               ``max_hold_chunks`` (the stage is about to
                               give up waiting for traffic)
  ``staleness_slo``            a ``serve.staleness`` sample exceeds the
                               SLO (default: the BENCH warm bound, 1
                               stage)
  ``overlap_collapse``         the cumulative prefetch overlap fraction
                               drops below the BENCH floor (0.5) after a
                               warmup of ``min_loads`` loads
  ``nonfinite_loss``           a stage publishes a non-finite objective
                               value (``expand.decision``'s ``f_last``)
  ===========================  ==========================================

Each detection is emitted back into the stream as a typed ``health.<kind>``
instant (so it lands *inside* the run's trace, ordered against the events
that caused it), recorded on the monitor, and fanned out to any
``on_detection`` callbacks — the opt-in hook elastic runtimes or
expansion policies can use to react mid-run.  ``report()`` folds the
detections into a :class:`HealthReport` that saves next to ``RunReport``
(``health.json`` / ``health.txt``).

Thresholds come from ``ObsSpec.slo`` (see :data:`SLO_DEFAULTS`).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import threading

#: ``ObsSpec.slo`` knobs and their defaults.  ``max_hold_chunks`` is
#: normally taken from the wired TrafficDriven policy; set it here only
#: to override.
SLO_DEFAULTS = {
    "straggler_ratio": 3.0,      # recent pace > ratio * median(others)
    "straggler_min_loads": 3,    # per-host loads before judging
    "straggler_window": 8,       # recent loads in the pace window
    "hold_frac": 0.8,            # holds >= frac * max_hold_chunks
    "max_hold_chunks": None,
    "staleness_max": 1,          # BENCH_serve warm-staleness bound
    "overlap_floor": 0.5,        # BENCH_data §3.3 overlap floor
    "overlap_min_loads": 8,
}


@dataclasses.dataclass
class Detection:
    """One health finding, stamped where the stream stood when it fired."""
    kind: str
    message: str
    stage: int | None = None
    host: int | None = None
    fields: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Detector:
    """A streaming detector: ``observe(event) -> Detection | None``."""
    kind = "detector"

    def observe(self, event: dict) -> Detection | None:
        raise NotImplementedError

    def summary(self) -> dict:
        return {}


class StragglerDetector(Detector):
    """Per-host shard-load pace outliers.

    Tracks a trailing window of ``meter.load`` durations per host; a host
    whose recent mean pace exceeds ``ratio`` × the median of the other
    hosts' is flagged (once per host per stage — a slowed host re-flags
    as the run progresses, a recovered one stops)."""
    kind = "straggler"

    def __init__(self, *, ratio: float = 3.0, min_loads: int = 3,
                 window: int = 8):
        self.ratio = float(ratio)
        self.min_loads = int(min_loads)
        self.window = int(window)
        self._durs: dict[int, list[float]] = {}
        self._flagged: set = set()
        self.stage: int | None = None

    def _pace(self, host) -> float:
        durs = self._durs[host]
        return sum(durs) / len(durs)

    def observe(self, event: dict) -> Detection | None:
        if event["name"] == "stage.begin":
            self.stage = event["tags"].get("stage")
            return None
        if event["name"] != "meter.load":
            return None
        host = event["tags"].get("host")
        if not isinstance(host, int):
            return None
        durs = self._durs.setdefault(host, [])
        durs.append(float(event["fields"].get("duration_s", 0.0)))
        del durs[:-self.window]
        others = [self._pace(h) for h, d in self._durs.items()
                  if h != host and len(d) >= self.min_loads]
        if len(durs) < self.min_loads or not others:
            return None
        others.sort()
        m = len(others) // 2
        median = others[m] if len(others) % 2 else \
            0.5 * (others[m - 1] + others[m])
        pace = self._pace(host)
        key = (host, self.stage)
        if median > 0 and pace > self.ratio * median and \
                key not in self._flagged:
            self._flagged.add(key)
            return Detection(
                self.kind, host=host, stage=self.stage,
                message=f"host {host} load pace {pace:.4f}s vs median "
                        f"{median:.4f}s ({pace / median:.1f}x, "
                        f"threshold {self.ratio}x)",
                fields={"pace_s": pace, "median_s": median,
                        "ratio": pace / median})
        return None

    def summary(self) -> dict:
        return {"hosts": sorted(self._durs),
                "flagged": sorted(str(k) for k in self._flagged)}


class ExpansionStallDetector(Detector):
    """``TrafficDriven`` holds approaching ``max_hold_chunks`` — the
    expansion schedule is starving for traffic and about to seal the
    corpus early."""
    kind = "expansion_stall"

    def __init__(self, *, hold_frac: float = 0.8,
                 max_hold_chunks: int | None = None):
        self.hold_frac = float(hold_frac)
        self.max_hold_chunks = max_hold_chunks
        self._flagged: set = set()
        self.max_holds = 0

    def observe(self, event: dict) -> Detection | None:
        if event["name"] != "serve.hold" or not self.max_hold_chunks:
            return None
        f = event["fields"]
        holds, stage = int(f.get("holds", 0)), f.get("stage")
        self.max_holds = max(self.max_holds, holds)
        limit = self.hold_frac * self.max_hold_chunks
        if holds >= limit and stage not in self._flagged:
            self._flagged.add(stage)
            return Detection(
                self.kind, stage=stage,
                message=f"stage {stage} held {holds} chunks "
                        f"(>= {self.hold_frac:.0%} of "
                        f"max_hold_chunks={self.max_hold_chunks})",
                fields={"holds": holds,
                        "max_hold_chunks": self.max_hold_chunks})
        return None

    def summary(self) -> dict:
        return {"max_holds": self.max_holds,
                "max_hold_chunks": self.max_hold_chunks}


class StalenessSLODetector(Detector):
    """``serve.staleness`` samples beyond the SLO (stages behind the
    newest published checkpoint a served request's weights were)."""
    kind = "staleness_slo"

    def __init__(self, *, staleness_max: int = 1):
        self.staleness_max = int(staleness_max)
        self.samples = 0
        self.breaches = 0

    def observe(self, event: dict) -> Detection | None:
        if event["name"] != "serve.staleness":
            return None
        stale = event["fields"].get("staleness")
        self.samples += 1
        if stale is None or stale <= self.staleness_max:
            return None
        self.breaches += 1
        return Detection(
            self.kind,
            message=f"served request {stale} stages behind the newest "
                    f"checkpoint (SLO: <= {self.staleness_max})",
            fields={"staleness": int(stale),
                    "staleness_max": self.staleness_max})

    def summary(self) -> dict:
        return {"samples": self.samples, "breaches": self.breaches,
                "staleness_max": self.staleness_max}


class OverlapCollapseDetector(Detector):
    """Cumulative prefetch overlap (1 - blocked/load over ``meter.load``)
    below the BENCH floor after warmup — §3.3's load/compute overlap has
    collapsed and stages are waiting on I/O."""
    kind = "overlap_collapse"

    def __init__(self, *, overlap_floor: float = 0.5,
                 overlap_min_loads: int = 8):
        self.floor = float(overlap_floor)
        self.min_loads = int(overlap_min_loads)
        self.loads = 0
        self.load_s = 0.0
        self.blocked_s = 0.0
        self._below = False

    def overlap(self) -> float:
        return 1.0 - self.blocked_s / self.load_s if self.load_s > 0 \
            else 1.0

    def observe(self, event: dict) -> Detection | None:
        if event["name"] != "meter.load":
            return None
        f = event["fields"]
        self.loads += 1
        self.load_s += float(f.get("duration_s", 0.0))
        self.blocked_s += float(f.get("blocked_s", 0.0))
        if self.loads < self.min_loads:
            return None
        ov = self.overlap()
        if ov < self.floor and not self._below:
            self._below = True          # re-arms if overlap recovers
            return Detection(
                self.kind,
                message=f"prefetch overlap {ov:.3f} below floor "
                        f"{self.floor} after {self.loads} loads",
                fields={"overlap": ov, "floor": self.floor,
                        "loads": self.loads})
        if ov >= self.floor:
            self._below = False
        return None

    def summary(self) -> dict:
        return {"loads": self.loads, "overlap": round(self.overlap(), 4),
                "floor": self.floor}


class NonFiniteLossDetector(Detector):
    """A stage published a non-finite objective — the run is numerically
    dead; catching it at the ``expand.decision`` that carried it beats
    reading NaNs out of the final trace."""
    kind = "nonfinite_loss"

    def __init__(self):
        self._flagged: set = set()

    def observe(self, event: dict) -> Detection | None:
        if event["name"] != "expand.decision":
            return None
        f = event["fields"]
        stage = event["tags"].get("stage")
        for key in ("f_last", "f_full_last"):
            v = f.get(key)
            if v is not None and not math.isfinite(v) and \
                    stage not in self._flagged:
                self._flagged.add(stage)
                return Detection(
                    self.kind, stage=stage,
                    message=f"stage {stage} {key}={v!r} is non-finite",
                    fields={key: str(v)})
        return None

    def summary(self) -> dict:
        return {"flagged_stages": sorted(
            s for s in self._flagged if s is not None)}


class HealthMonitor:
    """Streaming health over a live recorder.

    ``attach(recorder)`` taps the stream (a :class:`FleetRecorder` fans
    the tap across every lane); each event runs through every detector,
    and each finding is (1) emitted back as a ``health.<kind>`` instant,
    (2) kept on ``detections``, (3) passed to every ``on_detection``
    callback.  ``report()`` is the end-of-run :class:`HealthReport`."""

    def __init__(self, detectors=None, *, slo: dict | None = None):
        cfg = dict(SLO_DEFAULTS)
        unknown = set(slo or ()) - set(cfg)
        if unknown:
            raise ValueError(f"unknown slo knobs {sorted(unknown)}; "
                             f"known: {sorted(cfg)}")
        cfg.update(slo or {})
        self.slo = cfg
        self.detectors: list[Detector] = list(detectors) if detectors \
            is not None else [
            StragglerDetector(ratio=cfg["straggler_ratio"],
                              min_loads=cfg["straggler_min_loads"],
                              window=cfg["straggler_window"]),
            ExpansionStallDetector(hold_frac=cfg["hold_frac"],
                                   max_hold_chunks=cfg["max_hold_chunks"]),
            StalenessSLODetector(staleness_max=cfg["staleness_max"]),
            OverlapCollapseDetector(
                overlap_floor=cfg["overlap_floor"],
                overlap_min_loads=cfg["overlap_min_loads"]),
            NonFiniteLossDetector(),
        ]
        self.detections: list[Detection] = []
        self.events_seen = 0
        self._lock = threading.Lock()
        self._callbacks: list = []
        self._sink = None

    # ---------------------------------------------------------------- wiring
    def attach(self, recorder) -> "HealthMonitor":
        """Tap ``recorder`` (the first attach also becomes the emission
        sink for ``health.*`` events)."""
        if self._sink is None:
            self._sink = recorder
        recorder.add_listener(self.observe)
        return self

    def on_detection(self, callback) -> None:
        """Opt-in hook: ``callback(Detection)`` on every finding — the
        consumption point for elastic runtimes / expansion policies."""
        self._callbacks.append(callback)

    def detector(self, kind: str) -> Detector:
        for d in self.detectors:
            if d.kind == kind:
                return d
        raise KeyError(kind)

    def set_hold_limit(self, max_hold_chunks: int) -> None:
        """Late-bind the expansion-stall limit (the serve loop knows the
        wired policy's ``max_hold_chunks`` only after composition)."""
        det = self.detector("expansion_stall")
        if det.max_hold_chunks is None:
            det.max_hold_chunks = int(max_hold_chunks)

    # -------------------------------------------------------------- observe
    def observe(self, event: dict) -> None:
        if event["name"].startswith("health."):
            return                      # never react to our own emissions
        found: list[Detection] = []
        with self._lock:
            self.events_seen += 1
            for d in self.detectors:
                det = d.observe(event)
                if det is not None:
                    self.detections.append(det)
                    found.append(det)
        for det in found:
            if self._sink is not None:
                tags = {}
                if det.stage is not None:
                    tags["stage"] = det.stage
                if det.host is not None:
                    tags["host"] = det.host
                self._sink.instant(f"health.{det.kind}", tags=tags or None,
                                   message=det.message, **det.fields)
            for cb in self._callbacks:
                cb(det)

    # --------------------------------------------------------------- report
    def report(self) -> "HealthReport":
        with self._lock:
            return HealthReport(
                detections=list(self.detections),
                detectors={d.kind: d.summary() for d in self.detectors},
                events_seen=self.events_seen, slo=dict(self.slo))


class HealthReport:
    """End-of-run health: every detection plus per-detector summaries.
    Saves next to ``RunReport`` as ``health.json`` / ``health.txt``."""

    def __init__(self, *, detections, detectors, events_seen, slo):
        self.detections = detections
        self.detectors = detectors
        self.events_seen = events_seen
        self.slo = slo

    @property
    def healthy(self) -> bool:
        return not self.detections

    @classmethod
    def from_events(cls, events, *, slo: dict | None = None
                    ) -> "HealthReport":
        """Replay a recorded stream (a loaded log, a merged fleet trace)
        through fresh detectors — post-hoc health over any event source."""
        mon = HealthMonitor(slo=slo)
        for e in events:
            mon.observe(e)
        return mon.report()

    def to_dict(self) -> dict:
        return {"healthy": self.healthy,
                "detections": [d.to_dict() for d in self.detections],
                "detectors": self.detectors,
                "events_seen": self.events_seen,
                "slo": {k: v for k, v in self.slo.items()}}

    def to_text(self) -> str:
        lines = [f"health: {'OK' if self.healthy else 'DEGRADED'} "
                 f"({len(self.detections)} detection(s) over "
                 f"{self.events_seen} events)"]
        for d in self.detections:
            where = f" stage={d.stage}" if d.stage is not None else ""
            who = f" host={d.host}" if d.host is not None else ""
            lines.append(f"  [{d.kind}]{where}{who} {d.message}")
        for kind, summ in self.detectors.items():
            lines.append(f"  {kind}: " + json.dumps(summ, sort_keys=True))
        return "\n".join(lines) + "\n"

    def save(self, directory) -> dict:
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        out = {"health_json": str(d / "health.json"),
               "health_txt": str(d / "health.txt")}
        with open(out["health_json"], "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)
        with open(out["health_txt"], "w") as fh:
            fh.write(self.to_text())
        return out
