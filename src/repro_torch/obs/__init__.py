"""repro_torch.obs — the telemetry core, the port's copy of ``repro.obs``
without JAX (the reference's modules here import none either).

``events``  structured span/instant/counter recorder, JSONL + Chrome trace
``metrics`` registry + adapters wrapping DataAccessMeter/SimulatedClock/
            BetServer so the serve loop's claims are re-derivable from the
            stream
``report``  end-of-run RunReport: per-stage table, Thm 4.1 accounting,
            expansion decisions, claim recomputation, the serve summary

The reference's ``fleet``, ``health``, ``profile`` and ``regress``, and the
``Session`` wiring of ``ObsSpec``, come with the observability slice
(ROADMAP queue A11).
"""
from .events import (Event, EventRecorder, chrome_trace, from_jsonl,
                     read_log, validate_events, write_jsonl)
from .metrics import (MetricsRegistry, attach_clock, attach_dataset,
                      attach_meter, attach_prefetcher, attach_server)
from .report import RunReport

__all__ = [
    "Event", "EventRecorder", "chrome_trace", "from_jsonl", "read_log",
    "validate_events", "write_jsonl", "MetricsRegistry", "attach_clock",
    "attach_dataset", "attach_meter", "attach_prefetcher", "attach_server",
    "RunReport",
]
