"""The shares the per-layer readers report, from a run's records."""
from __future__ import annotations

import sys

from . import devtrace


def idle_percent(rec: dict):
    """The traced span's time with nothing on the device, in percent."""
    span = rec.get("span")
    if span is None or not span.device or span.end_ns <= span.start_ns:
        return None
    busy = devtrace.merged_busy_ns(span.device, span.start_ns, span.end_ns)
    return 100.0 * (1.0 - busy / (span.end_ns - span.start_ns))


def kernel_events(rec: dict, marker: str) -> list:
    """The traced span's events of the kernel whose name holds
    ``marker``, in launch order."""
    span = rec.get("span")
    if span is None:
        return []
    return sorted((e for e in span.device if marker in e[0]),
                  key=lambda e: e[1])


def roofline_by_marker(rec: dict, marker: str, kernel_mark: str,
                       bounds_ms: list, kernel: str):
    """``roofline_percent`` over the stretches of the span that the host
    markers ``marker`` enclose, ``bounds_ms[i]`` the bounds of the launches
    the run counted in the i-th, in launch order; a stretch whose events
    do not match its count is left out (and noted)."""
    span = rec.get("span")
    if span is None:
        return None
    events = kernel_events(rec, kernel_mark)
    kept_ev, kept_b = [], []
    for i, (lo, hi) in enumerate(span.markers(marker)):
        evs = [e for e in events if lo <= e[1] <= hi]
        if i < len(bounds_ms) and len(evs) == len(bounds_ms[i]):
            kept_ev += evs
            kept_b += bounds_ms[i]
        else:
            print(f"perfbench: {kernel}: {marker} {i}: the trace holds "
                  f"{len(evs)} launches, the run counted "
                  f"{len(bounds_ms[i]) if i < len(bounds_ms) else 0}; "
                  f"left out", file=sys.stderr)
    return roofline_percent(kept_ev, kept_b, kernel)


def roofline_percent(events: list, bounds_ms: list, kernel: str):
    """Σ bound / Σ device time of ``events``, in percent, where each event
    has its bound; None (and a note) where the launches the run counted
    do not match the events the trace holds."""
    if not events:
        return None
    if len(events) != len(bounds_ms):
        print(f"perfbench: {kernel}: the trace holds {len(events)} "
              f"launches, the run counted {len(bounds_ms)}; no share",
              file=sys.stderr)
        return None
    return 100.0 * sum(bounds_ms) * 1e-3 / (sum(e[2] for e in events) * 1e-9)
