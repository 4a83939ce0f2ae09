"""The paper's §4.2 time-complexity model, as an explicit simulated clock.

Architecture parameters:
  * ``p`` — hardware acceleration: processing one data point takes 1/p units,
  * ``a`` — sequential data-loading: one *new* point becomes available every
    ``a`` units (loading runs concurrently with computation),
  * ``s`` — fixed overhead between two consecutive inner-optimizer calls.

Charging rules (Table 1):
  * batch-style update on a window of n already-permuted points: the call
    blocks until n points have been loaded (concurrent loading), then costs
    ``s + n/p``.  Only *new* points count as data loads.
  * stochastic (resampled) update on b points: resampling defeats the
    sequential prefetcher, so every access pays the load rate:
    ``s + b*(a + 1/p)``.
  * evaluation passes (e.g. the two-track condition (3)) cost compute only.

On an accelerator, ``a`` models per-host loading/normalization of fresh
shards and ``p`` the device's aggregate throughput; the algebra is identical.
This is a pure-Python copy of ``repro.core.timemodel``: its clock columns
must equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SimulatedClock:
    p: float = 10.0
    a: float = 1.0
    s: float = 5.0
    preloaded: int = 0          # points available at t=0

    time: float = 0.0
    data_accesses: int = 0      # total points touched by optimizer calls
    points_loaded: int = 0      # unique points pulled from storage

    def available(self) -> float:
        """Points loaded by now under concurrent sequential loading."""
        return self.preloaded + self.time / self.a

    def wait_for(self, n: int) -> None:
        """Block until n unique points are resident."""
        if n > self.points_loaded:
            need_time = (n - self.preloaded) * self.a
            self.time = max(self.time, need_time)
            self.points_loaded = max(self.points_loaded, n)

    def batch_update(self, n: int) -> None:
        self.wait_for(n)
        self.time += self.s + n / self.p
        self.data_accesses += n

    def eval_pass(self, n: int) -> None:
        """Measurement/condition evaluation over resident data."""
        self.time += n / self.p
        self.data_accesses += n

    def stochastic_update(self, b: int) -> None:
        self.time += self.s + b * (self.a + 1.0 / self.p)
        self.data_accesses += b
        self.points_loaded += b  # resampled loads (may recount points)

    def spec_params(self) -> dict:
        """This clock's architecture parameters in ``ScheduleSpec.clock``
        form.  Only a *fresh* clock is expressible as spec parameters —
        elapsed time/accesses would be silently dropped, so a used clock
        is rejected instead."""
        if self.time or self.data_accesses or \
                self.points_loaded > self.preloaded:
            raise ValueError(
                "a used SimulatedClock cannot be expressed as spec "
                "parameters (its elapsed time/accesses would be dropped); "
                "pass a fresh clock")
        return {"p": self.p, "a": self.a, "s": self.s,
                "preloaded": self.preloaded}

    def snapshot(self) -> dict:
        return {"time": self.time, "accesses": self.data_accesses,
                "loaded": self.points_loaded}

    def restore(self, snap: dict) -> None:
        """Inverse of ``snapshot``: a resumed run replays §4.2 charges on
        top of the exact clock state the checkpoint captured, so the
        stitched trajectory's time/access columns are bit-identical to the
        uninterrupted run's."""
        self.time = float(snap["time"])
        self.data_accesses = int(snap["accesses"])
        self.points_loaded = int(snap["loaded"])
