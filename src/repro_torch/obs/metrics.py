"""Metric registry + adapters that *wrap* the existing meters; the port's
copy of ``repro.obs.metrics``.

The repo already has three battle-tested accounting surfaces —
``DataAccessMeter`` (real I/O), ``SimulatedClock`` (§4.2 charges) and
``BetServer``'s swap/throughput stats.  This module never replaces them:
the ``attach_*`` adapters shadow the relevant *bound methods on one
instance* so every update both mutates the original counters (all existing
snapshots, checkpoints and BENCH claims are untouched) and mirrors the same
payload into the :class:`~repro_torch.obs.events.EventRecorder` stream.  The
emitted events carry the full update arguments, so every BENCH claim is
re-derivable from the event stream alone (``repro_torch.obs.report.RunReport``
does exactly that and cross-checks against the meters).

Instance-attribute shadowing is deliberate: ``DataAccessMeter`` snapshots
through ``dataclasses.asdict``/``fields``, which walk *declared fields
only*, so wrapping adds no state the checkpoint layer could see.

``MetricsRegistry`` is the generic counter/gauge/histogram surface for
consumers that want aggregates instead of the raw stream; ``from_events``
folds a recorded stream back into one.
"""
from __future__ import annotations

import dataclasses
import math


# ------------------------------------------------------------------ registry
@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, by: float = 1.0) -> None:
        self.value += by


@dataclasses.dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary (count/sum/min/max) — enough for latency tails at
    CI scale without reservoir machinery."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0}


class MetricsRegistry:
    """Name-addressable counters/gauges/histograms."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }

    @classmethod
    def from_events(cls, events) -> "MetricsRegistry":
        """Fold a recorded stream into aggregates: ``meter.*`` payloads sum
        into counters, span durations feed per-name histograms, the last
        ``counter``-kind event of each name sets a gauge."""
        reg = cls()
        for e in events:
            name, kind = e["name"], e["kind"]
            fields = e.get("fields") or {}
            if kind == "span":
                reg.histogram(f"{name}.dur_s").observe(e.get("dur") or 0.0)
            elif kind == "counter":
                for k, v in fields.items():
                    if isinstance(v, (int, float)) and \
                            not isinstance(v, bool):
                        reg.gauge(f"{name}.{k}").set(v)
            if name.startswith("meter."):
                reg.counter(f"{name}.count").inc()
                for k, v in fields.items():
                    if isinstance(v, bool):
                        reg.counter(f"{name}.{k}").inc(int(v))
                    elif isinstance(v, (int, float)):
                        reg.counter(f"{name}.{k}").inc(v)
        return reg


# ------------------------------------------------------------------ adapters
def attach_meter(meter, recorder, **tags):
    """Shadow one ``DataAccessMeter`` instance's record methods so every
    update also lands in the event stream (``meter.load`` / ``meter.upload``
    / ``meter.access``) with its full payload.  Idempotent per instance;
    ``tags`` (e.g. ``host=2``) label every emitted event."""
    if getattr(meter, "_obs_recorder", None) is recorder:
        return meter
    orig_load = meter.record_load
    orig_upload = meter.record_upload
    orig_access = meter.record_access
    tag = dict(tags) or None

    def record_load(*, nbytes, examples, duration_s, blocked_s, prefetched):
        orig_load(nbytes=nbytes, examples=examples, duration_s=duration_s,
                  blocked_s=blocked_s, prefetched=prefetched)
        recorder.instant("meter.load", tags=tag, nbytes=int(nbytes),
                         examples=int(examples), duration_s=float(duration_s),
                         blocked_s=float(blocked_s),
                         prefetched=bool(prefetched))

    def record_upload(*, nbytes, examples):
        orig_upload(nbytes=nbytes, examples=examples)
        recorder.instant("meter.upload", tags=tag, nbytes=int(nbytes),
                         examples=int(examples))

    def record_access(examples):
        orig_access(examples)
        recorder.instant("meter.access", tags=tag, examples=int(examples))

    meter.record_load = record_load
    meter.record_upload = record_upload
    meter.record_access = record_access
    meter._obs_recorder = recorder
    return meter


def attach_clock(clock, recorder, **tags):
    """Shadow one ``SimulatedClock`` instance's charge methods: every §4.2
    charge emits a ``clock.charge`` event carrying the operation, its size
    and the post-charge totals — the simulated timeline, replayable."""
    if getattr(clock, "_obs_recorder", None) is recorder:
        return clock
    tag = dict(tags) or None

    def wrap(op, orig):
        def charged(n):
            orig(n)
            recorder.instant("clock.charge", tags=tag, op=op, n=int(n),
                             time=clock.time, accesses=clock.data_accesses,
                             loaded=clock.points_loaded)
        return charged

    clock.batch_update = wrap("batch_update", clock.batch_update)
    clock.eval_pass = wrap("eval_pass", clock.eval_pass)
    clock.stochastic_update = wrap("stochastic_update",
                                   clock.stochastic_update)
    clock._obs_recorder = recorder
    return clock


def attach_server(server, recorder, **tags):
    """Shadow one ``BetServer``'s ``adopt`` so every successful hot swap
    emits ``serve.swap`` with the adopted stage and measured latency."""
    if getattr(server, "_obs_recorder", None) is recorder:
        return server
    orig_adopt = server.adopt
    tag = dict(tags) or None

    def adopt(stage, params, *, t_detect=None):
        swapped = orig_adopt(stage, params, t_detect=t_detect)
        if swapped:
            recorder.instant(
                "serve.swap", tags=tag, stage=int(stage),
                latency_s=server.swap_latencies_s[-1],
                swap_count=server.swap_count)
        return swapped

    server.adopt = adopt
    server._obs_recorder = recorder
    return server


def attach_prefetcher(prefetcher, recorder, **tags):
    """Wire a ``Prefetcher``'s event hooks (it emits ``prefetch.scheduled``
    / ``prefetch.loaded`` / ``prefetch.landed`` / ``prefetch.cancelled``
    when a recorder is attached; ``prefetch.loaded`` fires on the worker
    thread)."""
    prefetcher.recorder = recorder
    prefetcher.recorder_tags = dict(tags)
    return prefetcher


def attach_dataset(dataset, recorder):
    """Wire recorders through any dataset flavor.

    Multi-host (``DistributedDataset`` / ``ElasticDataset``): wrap each
    *per-host* meter (tagged ``host=h``) plus the engine's access meter, and
    each lane plane's prefetcher — never the ``meter`` property, which
    builds a fresh combined object per call.  ``_obs_recorder`` is stashed
    on the dataset so elastically *rebuilt* lane planes (host loss) re-wire
    their fresh prefetchers inside ``_make_plane``.  When ``recorder`` is
    a fleet recorder (``obs.fleet.FleetRecorder``, with per-host
    ``lane`` streams), each host's meter and prefetcher emit into that
    host's own lane instead of the shared stream.

    Single-host ``StreamingDataset``: its one meter and prefetcher.  Plain
    host-slice datasets have no meters; no-op."""
    planes = getattr(dataset, "planes", None)
    if planes is not None:
        dataset._obs_recorder = recorder
        lane = getattr(recorder, "lane", None)
        for h, plane in planes.items():
            host_rec = lane(h) if lane is not None else recorder
            attach_meter(dataset.host_meters[h], host_rec, host=int(h))
            attach_prefetcher(plane.prefetcher, host_rec, host=int(h))
        attach_meter(dataset._access, recorder, src="access")
        return dataset
    meter = getattr(dataset, "meter", None)
    if meter is not None:
        attach_meter(meter, recorder)
    prefetcher = getattr(dataset, "prefetcher", None)
    if prefetcher is not None:
        attach_prefetcher(prefetcher, recorder)
    if hasattr(dataset, "recorder"):
        # datasets with their own event vocabulary (the tiered corpus's
        # ``tier.*`` stream) take the recorder directly
        dataset.recorder = recorder
    return dataset
