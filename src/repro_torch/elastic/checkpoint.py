"""Stage-boundary checkpoints: the *full* BET runtime state of a
single-host run — the port of ``repro.elastic.checkpoint`` for the
``"plain"`` and ``"streaming"`` datasets.

A resumable BET run needs more than (params, opt_state): the window cursor
``(stage, n_t, step)``, the simulated clock, the ``DataAccessMeter``
counters and the trace so far.  Because the window is a prefix of one
fixed permutation, that is *everything*: a fresh process re-reads the
``[0, n_t)`` prefix (charged to a separate "rewarm" record so the restored
Thm 4.1 counters stay bit-compatible with the uninterrupted run) and
continues the schedule from ``stage + 1`` with identical numerics and
identical accounting.

The reference's ``"distributed"`` and ``"tiered"`` dataset kinds come with
the distributed slice (ROADMAP queue A8) and the tiered corpus (A11); a
checkpoint of either kind is refused on restore.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

from ..checkpoint.ckpt import load_state, save_state
from ..core.engine import ResumeState, StageEnd
from ..core.timemodel import SimulatedClock
from ..data.plane import StreamingDataset

_PENDING_KINDS = {
    "distributed": "the distributed slice (ROADMAP queue A8)",
    "tiered": "the tiered-corpus slice (ROADMAP queue A11)",
}


# ------------------------------------------------------------ dataset state
def _dataset_kind(dataset) -> str:
    return "streaming" if isinstance(dataset, StreamingDataset) else "plain"


def dataset_state(dataset) -> dict:
    """JSON-safe runtime state of a dataset: the plane's meter counters and
    window cursor; nothing for a host-resident dataset."""
    if _dataset_kind(dataset) == "plain":
        return {"kind": "plain"}
    return {"kind": "streaming", "meter": dataset.meter.snapshot(),
            "window_cursor": dataset.windows[0].cursor()}


def restore_dataset(dataset, state: dict, n_t: int) -> dict:
    """Bring a *freshly constructed* dataset to the checkpointed state.

    Order matters: (1) re-land the resident prefix ``[0, n_t)`` (real
    storage reads), cross-checked against the checkpointed window cursor;
    (2) capture that restart I/O as the returned ``rewarm`` record; (3)
    overwrite the meter with the checkpointed counters — the resumed
    accounting continues exactly where the uninterrupted run would be,
    with the restart cost reported separately instead of silently
    double-counted."""
    kind = state.get("kind", "plain")
    if kind in _PENDING_KINDS:
        raise ValueError(
            f"checkpoint was taken on a {kind!r} dataset, which is not yet "
            f"ported to repro_torch; it comes with {_PENDING_KINDS[kind]}")
    have = _dataset_kind(dataset)
    if kind != have:
        raise ValueError(
            f"checkpoint was taken on a {kind!r} dataset but the resume "
            f"constructed a {have!r} one ({type(dataset).__name__}) — "
            f"meters/cursors would be silently mismatched; resume with the "
            f"same data-plane configuration")
    if kind == "plain":
        return {}
    dataset.window(n_t)
    _check_cursor(state["window_cursor"], dataset.windows[0].cursor(), n_t)
    rewarm = dataset.meter.snapshot()
    dataset.meter.restore(state["meter"])
    return rewarm


def _check_cursor(saved, rebuilt, n_t: int) -> None:
    """The re-warmed residency must land within the checkpointed cursor.

    Equality is the normal case; the checkpointed run may legitimately
    have been resident *beyond* ``n_t`` (e.g. a full-corpus eval view
    forced residency), which the resumed ``run()`` re-establishes itself.
    But a rewarm that *overshoots* the saved cursor means the resumed
    dataset was built over different shards — its 'resident' window
    would silently diverge from the permutation prefix the schedule
    believes is loaded."""
    if saved is None or rebuilt is None:
        return
    if rebuilt["n_valid"] > saved["n_valid"]:
        raise ValueError(
            f"re-warmed window cursor {rebuilt} overshoots the "
            f"checkpointed cursor {saved} at n_t={n_t}: the resumed "
            f"dataset's sharding differs from the checkpointed run's")


def _point_dicts(trace) -> list[dict]:
    return [{"step": p.step, "stage": p.stage, "window": p.window,
             "time": p.time, "accesses": p.accesses,
             "f_window": p.f_window, "f_full": p.f_full, "extra": p.extra}
            for p in trace.points]


# ------------------------------------------------------------- checkpointer
@dataclasses.dataclass
class StageCheckpointer:
    """Rolling stage-boundary checkpoints; plugs into
    ``BetEngine.stage_callback``.  ``every`` thins the cadence (checkpoint
    after stages 0, every, 2*every, ...); the final stage always saves.
    ``keep`` bounds the checkpoints on disk.  ``spec`` (a
    ``RunSpec.to_dict()``) is saved into every checkpoint's meta, making
    the checkpoint a self-describing, re-buildable artifact."""
    directory: str
    keep: int = 3
    every: int = 1
    spec: dict | None = None

    def __post_init__(self):
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        self.saved: list[int] = []

    def __call__(self, end: StageEnd) -> None:
        if end.info.stage % self.every and not end.info.is_final:
            return
        self.save(end)

    def save(self, end: StageEnd) -> pathlib.Path:
        d = pathlib.Path(self.directory)
        path = d / f"stage_{end.info.stage:04d}"
        # publish atomically: write under a dot-prefixed temp name (invisible
        # to the stage_*.npz glob), then os.replace into place — a reader
        # either sees the full checkpoint or none of it.  The .json lands
        # before the .npz because readers key on the .npz: once it appears,
        # its sidecar exists.
        tmp = d / f".tmp_{path.name}"
        meta = {
            "cursor": {"stage": end.info.stage, "n_t": end.info.n_t,
                       "n_next": end.info.n_next, "step": end.step_count,
                       "stages": end.stages, "transfers": end.transfers,
                       "overshoot": end.overshoot},
            "clock": end.clock.snapshot(),
            "dataset": dataset_state(end.dataset),
            "trace": {"method": end.trace.method,
                      "points": _point_dicts(end.trace)},
        }
        if self.spec is not None:
            meta["spec"] = self.spec
        save_state(tmp, {"params": end.params, "opt": end.opt_state},
                   meta=meta)
        os.replace(tmp.with_suffix(".json"), path.with_suffix(".json"))
        os.replace(tmp.with_suffix(".npz"), path.with_suffix(".npz"))
        self.saved.append(end.info.stage)
        ckpts = sorted(d.glob("stage_*.npz"))
        for old in ckpts[: -self.keep]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)
        return path

    def latest(self) -> pathlib.Path | None:
        ckpts = sorted(pathlib.Path(self.directory).glob("stage_*.npz"))
        return ckpts[-1].with_suffix("") if ckpts else None

    def restore(self, params_like, opt_like=None) -> "RestoredRun | None":
        latest = self.latest()
        if latest is None:
            return None
        return load_stage_checkpoint(latest, params_like, opt_like)


def peek_stage_meta(path) -> dict:
    """A stage checkpoint's sidecar metadata (cursor/clock/dataset/spec)
    without loading any arrays — spec validation reads this."""
    sidecar = json.loads(pathlib.Path(path).with_suffix(".json").read_text())
    return sidecar["meta"]


def load_stage_checkpoint(path, params_like, opt_like=None) -> "RestoredRun":
    trees, meta = load_state(path, {"params": params_like, "opt": opt_like})
    return RestoredRun(params=trees["params"], opt_state=trees["opt"],
                       meta=meta)


@dataclasses.dataclass
class RestoredRun:
    """A loaded stage checkpoint plus the helpers a resume needs."""
    params: object
    opt_state: object
    meta: dict

    @property
    def resume(self) -> ResumeState:
        c = self.meta["cursor"]
        # a reference checkpoint has no race overshoot in its cursor
        return ResumeState(next_stage=c["stage"] + 1, step_count=c["step"],
                           stages=c["stages"], transfers=c["transfers"],
                           overshoot=c.get("overshoot", 0))

    @property
    def n_t(self) -> int:
        return int(self.meta["cursor"]["n_t"])

    def restore_clock(self, clock: SimulatedClock) -> SimulatedClock:
        clock.restore(self.meta["clock"])
        return clock

    def restore_dataset(self, dataset) -> dict:
        """Re-land the resident window and restore meters; returns the
        rewarm I/O record (see ``restore_dataset``)."""
        return restore_dataset(dataset, self.meta["dataset"], self.n_t)

    def trace_points(self) -> list[dict]:
        """The pre-checkpoint trajectory, for stitching a resumed trace
        against an uninterrupted reference."""
        return list(self.meta["trace"]["points"])
