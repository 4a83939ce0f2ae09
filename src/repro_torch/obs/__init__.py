"""repro_torch.obs — one telemetry plane for the port's BET stack, the
port's copy of ``repro.obs`` (whose modules import no JAX, except the
profiler, which is ported).

``events``  structured span/instant/counter recorder, JSONL + Chrome trace
``fleet``   per-host event lanes + the cross-host merger (clock alignment
            at stage-flush barriers, causally-ordered FleetTrace)
``health``  live streaming detectors (stragglers, expansion stalls,
            staleness SLO, overlap collapse, non-finite loss) + HealthReport
``metrics`` registry + adapters wrapping DataAccessMeter/SimulatedClock/
            BetServer so the claims are re-derivable from the stream
``report``  end-of-run RunReport: per-stage table, Thm 4.1 accounting,
            expansion decisions, claim recomputation, the serve summary
``regress`` bench regression sentinel: BENCH_*.json vs committed anchors,
            BENCH_history.jsonl trajectory rendering
``profile`` opt-in ``torch.profiler`` capture + per-stage FLOP/byte counts
            with H100 roofline seconds (import ``repro_torch.obs.profile``
            directly, as the reference's is imported)
"""
from .events import (Event, EventRecorder, chrome_trace, from_jsonl,
                     read_log, validate_events, write_jsonl)
from .fleet import FleetRecorder, FleetTrace, merge_streams
from .health import (SLO_DEFAULTS, Detection, HealthMonitor, HealthReport)
from .metrics import (MetricsRegistry, attach_clock, attach_dataset,
                      attach_meter, attach_prefetcher, attach_server)
from .report import RunReport

__all__ = [
    "Event", "EventRecorder", "chrome_trace", "from_jsonl", "read_log",
    "validate_events", "write_jsonl", "FleetRecorder", "FleetTrace",
    "merge_streams", "SLO_DEFAULTS", "Detection", "HealthMonitor",
    "HealthReport", "MetricsRegistry", "attach_clock", "attach_dataset",
    "attach_meter", "attach_prefetcher", "attach_server", "RunReport",
]
