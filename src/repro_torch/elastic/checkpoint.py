"""Stage-boundary checkpoints: the *full* BET runtime state — the port of
``repro.elastic.checkpoint`` for the ``"plain"``, ``"streaming"`` and
``"distributed"`` datasets.

A resumable BET run needs more than (params, opt_state): the window cursor
``(stage, n_t, step)``, the simulated clock, the per-lane
``DataAccessMeter`` counters, the trace so far, and — elastically — the
lane→worker assignment and owned-shard lists after any deltas.  Because
the window is a prefix of one fixed permutation, that is *everything*: a
fresh process re-reads the ``[0, n_t)`` prefix (charged to a separate
"rewarm" record so the restored Thm 4.1 counters stay bit-compatible with
the uninterrupted run) and continues the schedule from ``stage + 1`` with
identical numerics and identical accounting.

A distributed checkpoint writes each lane's meter to its own file,
``<stem>_laneNN.json`` (the reference's ``data/tiers/ckpt.py`` format),
and its sidecar keeps a pointer to them; checkpoints cross between the
packages both ways.  The reference's ``"tiered"`` kind comes with the
tiered corpus (ROADMAP queue A11) and is refused on restore.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor

from ..checkpoint.ckpt import load_state, save_state
from ..core.engine import ResumeState, StageEnd
from ..core.timemodel import SimulatedClock
from ..data.plane import StreamingDataset
from ..dist.runtime import DistributedDataset

_PENDING_KINDS = {
    "tiered": "the tiered-corpus slice (ROADMAP queue A11)",
}


# ------------------------------------------------------------ dataset state
def _dataset_kind(dataset) -> str:
    if isinstance(dataset, DistributedDataset):
        return "distributed"
    return "streaming" if isinstance(dataset, StreamingDataset) else "plain"


def dataset_state(dataset) -> dict:
    """JSON-safe runtime state of a dataset: the meter counters and window
    cursors (per lane, with the elastic maps, for a distributed dataset);
    nothing for a host-resident dataset."""
    kind = _dataset_kind(dataset)
    if kind == "plain":
        return {"kind": "plain"}
    if kind == "streaming":
        return {"kind": "streaming", "meter": dataset.meter.snapshot(),
                "window_cursor": dataset.windows[0].cursor()}
    state = {"kind": "distributed",
             "host_meters": [m.snapshot() for m in dataset.host_meters],
             "access_meter": dataset._access.snapshot(),
             "window_cursor": dataset.stacked[0].cursor()}
    elastic = getattr(dataset, "elastic_state", None)
    if elastic is not None:
        state["elastic"] = elastic()
    return state


def restore_dataset(dataset, state: dict, n_t: int) -> dict:
    """Bring a *freshly constructed* dataset to the checkpointed state.

    Order matters: (1) elastic maps first, so lanes rebuild under the
    checkpointed ownership; (2) re-land the resident prefix ``[0, n_t)``
    (real storage reads), cross-checked against the checkpointed window
    cursor; (3) capture that restart I/O as the returned ``rewarm`` record;
    (4) overwrite the meters with the checkpointed counters — the resumed
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
            f"same hosts / data-plane configuration")
    if kind == "plain":
        return {}
    if kind == "distributed":
        if "elastic" in state:
            restore = getattr(dataset, "restore_elastic_state", None)
            if restore is None:
                raise ValueError(
                    "checkpoint carries elastic state but the dataset is "
                    f"a plain {type(dataset).__name__}")
            restore(state["elastic"])
        dataset.window(n_t)
        _check_cursor(state["window_cursor"],
                      dataset.stacked[0].cursor(), n_t)
        rewarm = dataset.meter.snapshot()
        for m, snap in zip(dataset.host_meters, state["host_meters"]):
            m.restore(snap)
        dataset._access.restore(state["access_meter"])
        return rewarm
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
    dataset was built over different shards or ownership — its
    'resident' window would silently diverge from the permutation prefix
    the schedule believes is loaded.  A distributed cursor is checked lane
    by lane."""
    if saved is None or rebuilt is None:
        return
    s = saved.get("counts", [saved.get("n_valid")])
    r = rebuilt.get("counts", [rebuilt.get("n_valid")])
    if len(s) != len(r) or any(ri > si for si, ri in zip(s, r)):
        raise ValueError(
            f"re-warmed window cursor {rebuilt} overshoots the "
            f"checkpointed cursor {saved} at n_t={n_t}: the resumed "
            f"dataset's sharding/ownership differs from the checkpointed "
            f"run's")


# ------------------------------------------------------- per-lane slice files
LANE_POINTER_KEY = "lane_files"


def is_lane_pointer(value) -> bool:
    """Is this ``host_meters`` entry a lane-file pointer (vs inline list)?"""
    return isinstance(value, dict) and LANE_POINTER_KEY in value


def write_lane_slices(directory, stem: str, host_meters) -> dict:
    """Write one ``<stem>_laneNN.json`` per lane meter snapshot, each by its
    own thread (the one-process stand-in for every host writing its own
    slice) and each through a temporary name and ``os.replace``; return
    the pointer to keep in the main sidecar."""
    d = pathlib.Path(directory)
    names = [f"{stem}_lane{i:02d}.json" for i in range(len(host_meters))]

    def write_one(i: int) -> None:
        tmp = d / f".tmp_{names[i]}"
        tmp.write_text(json.dumps({"lane": i, "meter": host_meters[i]}))
        os.replace(tmp, d / names[i])

    with ThreadPoolExecutor(max_workers=min(8, len(names)) or 1) as pool:
        list(pool.map(write_one, range(len(names))))
    return {LANE_POINTER_KEY: names}


def load_lane_slices(directory, pointer: dict) -> list[dict]:
    """Inflate a lane pointer back into the in-order meter snapshot list."""
    d = pathlib.Path(directory)
    return [json.loads((d / name).read_text())["meter"]
            for name in pointer[LANE_POINTER_KEY]]


def unlink_lane_slices(directory, stem: str) -> None:
    """Remove a checkpoint's lane files (the keep-rotation cleanup)."""
    for f in pathlib.Path(directory).glob(f"{stem}_lane*.json"):
        f.unlink(missing_ok=True)


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
    the checkpoint a self-describing, re-buildable artifact.  With an
    ``obs.EventRecorder`` as ``recorder`` every publish emits one
    ``checkpoint.publish`` span covering the atomic write."""
    directory: str
    keep: int = 3
    every: int = 1
    spec: dict | None = None
    recorder: object = None

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
        span = self.recorder.span(
            "checkpoint.publish", stage=end.info.stage, n_t=end.info.n_t) \
            if self.recorder is not None else contextlib.nullcontext()
        with span:
            return self._save(end)

    def _save(self, end: StageEnd) -> pathlib.Path:
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
        ds_state = meta["dataset"]
        if ds_state["kind"] == "distributed":
            # each lane writes its own slice file and the sidecar keeps a
            # pointer; lanes land before the .npz is published, so readers
            # (which key on the .npz) never see a checkpoint whose lanes
            # are missing
            ds_state["host_meters"] = write_lane_slices(
                d, path.name, ds_state["host_meters"])
        save_state(tmp, {"params": end.params, "opt": end.opt_state},
                   meta=meta)
        os.replace(tmp.with_suffix(".json"), path.with_suffix(".json"))
        os.replace(tmp.with_suffix(".npz"), path.with_suffix(".npz"))
        self.saved.append(end.info.stage)
        ckpts = sorted(d.glob("stage_*.npz"))
        for old in ckpts[: -self.keep]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)
            unlink_lane_slices(d, old.stem)
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
    ds_state = meta.get("dataset") or {}
    if is_lane_pointer(ds_state.get("host_meters")):
        ds_state["host_meters"] = load_lane_slices(
            pathlib.Path(path).parent, ds_state["host_meters"])
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
