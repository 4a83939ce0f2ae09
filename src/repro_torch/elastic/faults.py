"""Failure injection — kill / slow / rejoin a host at a stage boundary;
the port's copy of ``repro.elastic.faults``, line for line.

The elastic runtime's recovery paths are only trustworthy if they are
exercised deterministically, so faults are *scheduled*, not random: a
``FaultPlan`` maps stage indices to events, and ``ElasticBetEngine``
applies each stage's events at that stage's boundary (after the stage's
records flushed, before the next stage's residency) over a
``SimulatedTopology``.  That is exactly where a real deployment observes
membership changes — a heartbeat loss or a scale-up lands between
collective flushes, never mid-kernel.

Event semantics (``stage`` = the stage index that just *completed*):

  * ``kill``   — the worker's device memory and load channels are gone;
    its lanes are handed to surviving workers and rebuilt from storage
    (re-reading only the lost owned slice — see elastic/runtime.py).
  * ``slow``   — the worker's storage reads degrade to ``delay_s`` per
    shard (a failing NIC / contended NAS path); the deadline-based stage
    flush then migrates its not-yet-resident shards away.
  * ``rejoin`` — the worker is back (or a fresh replacement registered);
    it adopts a lane from the most-burdened survivor — a pure handover of
    driving responsibility, no storage re-read.
"""
from __future__ import annotations

import dataclasses

KINDS = ("kill", "slow", "rejoin")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    stage: int
    kind: str
    host: int
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"pick from {KINDS}")
        if self.stage < 0:
            raise ValueError(f"stage must be >= 0, got {self.stage}")
        if self.host < 0:
            raise ValueError(f"host must be >= 0, got {self.host}")
        if self.kind == "slow" and self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


class FaultPlan:
    """An ordered schedule of fault events, consumed stage by stage."""

    def __init__(self, events=()):
        self.events = tuple(sorted(events, key=lambda e: e.stage))

    @classmethod
    def parse(cls, specs) -> "FaultPlan":
        """CLI grammar, one event per spec string:

            kill@STAGE:HOST        e.g.  kill@2:1
            slow@STAGE:HOST=DELAY  e.g.  slow@1:3=0.02
            rejoin@STAGE:HOST      e.g.  rejoin@4:1
        """
        events = []
        for spec in specs:
            try:
                kind, rest = spec.split("@", 1)
                delay = 0.0
                if "=" in rest:
                    rest, d = rest.split("=", 1)
                    delay = float(d)
                stage, host = rest.split(":", 1)
                events.append(FaultEvent(stage=int(stage), kind=kind,
                                         host=int(host), delay_s=delay))
            except (ValueError, TypeError) as exc:
                if isinstance(exc, ValueError) and "fault kind" in str(exc):
                    raise
                raise ValueError(
                    f"bad fault spec {spec!r}: expected "
                    f"kind@stage:host[=delay]") from exc
        return cls(events)

    def at(self, stage: int) -> tuple:
        """Events scheduled for the boundary after ``stage``."""
        return tuple(e for e in self.events if e.stage == stage)

    def __bool__(self) -> bool:
        return bool(self.events)
