"""TrafficDriven — expansion keyed on data arrival, not gradient noise;
the port of ``repro.serve.policy``.

The adaptive-batch-size literature (Sievert's adaptive-batch SGD, the
Byrd et al. norm test behind ``GradientVariance``) grows the batch when the
*gradient* says so.  Serving flips the constraint: the window can only grow
as fast as traffic lands.  ``TrafficDriven`` expands when enough new
examples have been **sealed** by the online store to honor the engine's
stage target (``StageInfo.n_next``, i.e. the schedule's growth factor), and
otherwise *holds the stage open* — the engine runs more inner steps on the
current resident window, which is exactly BET's move: keep optimizing on
data you already hold instead of waiting idle (§3.3's overlap, applied to
arrival instead of loading).

Composability: this is an ordinary scan-kind ``ExpansionPolicy``, so the
existing ``PolicySpec`` combinators apply — e.g. TrafficDriven primary with
a GradientVariance veto expands only when enough data arrived AND the
gradient signal is exhausted; or as a veto itself, it keeps any primary
from outrunning ingestion.

Runtime wiring: the ``source`` (an ``OnlineShardStore``) and the optional
``pump`` callback (one serving tick: generate → log → ingest, see
serve/loop.py) are attached *after* construction via ``attach`` — they are
live objects, not spec parameters, so ``PolicySpec("traffic_driven")``
round-trips through JSON like every other registered policy.  Without a
source the policy degrades to FixedSteps behavior (every window is
"arrived" — the offline corpus is a closed source).
"""
from __future__ import annotations

import dataclasses

from ..core.engine import ExpansionPolicy, StageInfo, StageRecords


@dataclasses.dataclass
class TrafficDriven(ExpansionPolicy):
    """Expand when ingestion has sealed enough examples for the next window.

    ``inner_steps`` inner iterations run between arrival checks (each check
    is one ``should_expand`` consultation; a held stage therefore keeps
    training in ``inner_steps``-sized chunks).  ``final_steps`` applies to
    the final full-corpus stage once the source closes.  ``max_hold_chunks``
    bounds how many consecutive holds a stage tolerates — with a wired
    ``pump`` the bound translates to a traffic budget; without one it turns
    a would-be infinite hold into a diagnosable error."""
    inner_steps: int = 2
    final_steps: int = 8
    max_hold_chunks: int = 10_000
    name = "traffic_driven"
    eval_full = True

    def __post_init__(self):
        self.source = None          # OnlineShardStore (attach())
        self.pump = None            # callable: one serving tick (attach())
        self._holds = 0
        self.holds_total = 0        # lifetime holds (report/bench surface)
        self.recorder = None        # EventRecorder: emits serve.hold

    def attach(self, source, pump=None) -> "TrafficDriven":
        """Wire the live ingestion store and (optionally) the serving tick
        the policy drives while holding a stage open."""
        self.source = source
        self.pump = pump
        return self

    # ----------------------------------------------------------- protocol
    def stage_begin(self, info: StageInfo) -> None:
        self._holds = 0

    def plan_steps(self, info: StageInfo, done_steps: int) -> int:
        return self.final_steps if info.is_final else self.inner_steps

    def should_expand(self, info: StageInfo, records: StageRecords) -> bool:
        if info.is_final or info.n_next is None:
            return True
        if self.source is None:
            return True                 # offline: every window has arrived
        if self._arrived(info.n_next):
            return True
        # hold the stage open: run one serving tick so traffic keeps
        # landing while the engine keeps stepping on the resident window
        self._holds += 1
        self.holds_total += 1
        if self.recorder is not None:
            self.recorder.instant(
                "serve.hold", stage=info.stage, n_next=info.n_next,
                sealed=self.source.num_examples, holds=self._holds)
        if self.pump is not None:
            self.pump()
            if self._arrived(info.n_next):
                return True
        if self._holds >= self.max_hold_chunks:
            raise RuntimeError(
                f"traffic_driven held stage {info.stage} for {self._holds} "
                f"chunks waiting for {info.n_next} sealed examples "
                f"(have {self.source.num_examples}"
                f"{', no pump wired' if self.pump is None else ''}) — "
                f"close the source or wire a pump")
        return False

    def _arrived(self, n_next: int) -> bool:
        return self.source.num_examples >= n_next or \
            bool(getattr(self.source, "closed", False))
