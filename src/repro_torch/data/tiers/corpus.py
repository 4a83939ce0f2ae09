"""TieredCorpus — the engine-facing dataset over three storage tiers; the
port of ``repro.data.tiers.corpus``.

    disk shards  --Prefetcher-->  HostRing (host RAM)  --stage/commit-->
        DeviceWindow (HBM-hot window, budgeted)

The corpus speaks the same dataset protocol as
:class:`~repro_torch.data.plane.StreamingDataset` (``n`` / ``d`` /
``begin_stage`` / ``window`` / ``note_access`` / ``close``) plus the two
rotation hooks the engine drives when a stage window no longer fits the
HBM budget (``segment_steps`` / ``advance_window``).  Two regimes:

**Append** (``n_t <= hot_cap``): exactly the streaming plane's append-only
expansion — shard-rounded residency, one coalesced landing per expansion,
prefix-slice views — so trajectories are bit-compatible with the untiered
plane.  On top, expansions are *double-buffered*: at each stage begin the
**next** stage's slice is handed to a one-thread stager that pulls it from
the ring and copies it to the device while the current stage computes;
the next ``begin_stage`` lands the finished buffer with one in-place
device copy instead of a blocking upload (the §3.3 overlap, on the
host-to-device leg too).

**Rotation** (``n_t > hot_cap``): the stage window is swept in the
manager's disjoint stride-``hot_cap`` segments.  While the optimizer steps
on the hot segment, the stager promotes the *next* segment from the ring;
``advance_window`` commits it — copied over the hot segment in place, so
B1 sees one buffer and one shape for every full segment, and a view of the
segment before then shows the new rows (the engine drops it there) — and
immediately stages the one after, including the wrap segment ``[0, cap)``,
which by stride alignment is also the **next stage's** first segment, so
the sweep hand-off across expansions is free.  Disjoint tiling means an
incoming segment never overlaps the hot rows: zero resident re-upload
holds by construction and is *measured* by
``TierMeter.resident_reuploads``.
Re-promotions come from host RAM, so with an unbounded ring every example
leaves disk exactly once per run.

The stager on the card (the reference's ``jax.device_put`` and
``block_until_ready`` on the stager thread): the ring's shards are pinned,
and the stager copies the staged rows into a fresh device buffer with
``non_blocking`` copies on the corpus's own copy stream, records an event
there and waits on that event (its wait times the copy and keeps the
buffer alive until the copy is done, so a discarded buffer is never
reused while a copy still writes it).  The commit, on the driver, makes
the compute stream wait on the event (never a device-wide synchronize),
records the compute stream on the buffer for the allocator, and lands the
rows with ``DeviceWindow.append_staged``.  On the CPU the same copies run
synchronously and no stream or event exists.

Upload metering happens at **commit time on the driver thread** (never on
the stager), mirroring the DeviceWindow convention — bytes per field,
examples on field 0 — so the event-stream claim
``bytes_uploaded == examples_uploaded * row_bytes`` keeps holding, and a
discarded staged buffer is never counted as traffic.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Sequence

import torch

from ...device import resolve_device
from ..device_window import DeviceWindow
from ..prefetch import Prefetcher
from ..shards import DataAccessMeter, ShardStore, store_capacity
from .host import HostRing
from .manager import RingTierManager, TierMeter


@dataclasses.dataclass
class _Staged:
    """One in-flight staging job: rows [lo, hi) being promoted to the
    device on the stager thread.  ``append=True`` lands after the resident
    prefix (append regime); ``False`` replaces the hot segment (rotation)."""
    lo: int
    hi: int
    future: Future
    t0: float
    append: bool


class TieredCorpus:
    """HBM-hot expanding/rotating windows over host-RAM and disk tiers."""

    def __init__(self, stores: Sequence[ShardStore], *, hbm_bytes: int,
                 host_bytes: int = 0, growth: float = 2.0,
                 prefetch_workers: int = 1, max_inflight: int | None = None,
                 manager_cls=RingTierManager, device="cuda"):
        stores = tuple(stores)
        if not stores:
            raise ValueError("TieredCorpus needs at least one field store")
        self.stores = stores
        self.masked = False
        self.device = resolve_device(device)
        self.meter = DataAccessMeter()
        self.tier_meter = TierMeter()
        self.growth = float(growth)
        row_bytes = sum(s.example_nbytes for s in stores)
        # the checks that can fail come before anything holding a thread
        self.manager = manager_cls(
            hbm_bytes=hbm_bytes, row_bytes=row_bytes,
            shard_size=stores[0].shard_size,
            capacity=store_capacity(stores[0]))
        self.windows = tuple(
            DeviceWindow(capacity=self.hot_cap, item_shape=s.item_shape,
                         dtype=s.dtype, growth=self.growth,
                         meter=self.meter, meter_examples=i == 0,
                         device=self.device)
            for i, s in enumerate(stores))
        # the card's copy stream: made only for a corpus on the card
        self._copy_stream = torch.cuda.Stream(device=self.device) \
            if self.device.type == "cuda" else None
        self.prefetcher = Prefetcher(stores, self.meter,
                                     max_workers=prefetch_workers,
                                     max_inflight=max_inflight)
        self.ring = HostRing(stores, self.prefetcher, host_bytes=host_bytes,
                             tier_meter=self.tier_meter,
                             pin=self._copy_stream is not None)
        self._mode = "append"
        self._seg: tuple[int, int] | None = None     # hot segment (rotate)
        self._segments: list[tuple[int, int]] = []   # current stage tiling
        self._seg_idx = 0
        self._plan: list[int] = []                   # queued segment visits
        self._staged: _Staged | None = None
        # on the card: recorded on the compute stream once a commit's
        # staged buffers are free, waited on by the next staging job
        self._landed = None
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="bet-tier")
        self._recorder = None

    # ----------------------------------------------------------- properties
    @property
    def n(self) -> int:
        return self.stores[0].num_examples

    @property
    def d(self) -> int:
        """Feature dimension of the first field (the convex path's X)."""
        return self.stores[0].item_shape[0]

    @property
    def hot_cap(self) -> int:
        """Rows the HBM budget admits on device (shard-aligned)."""
        return self.manager.hot_cap

    @property
    def resident(self) -> int:
        """Rows currently valid in the device window."""
        return self.windows[0].n_valid

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def hot_range(self) -> tuple[int, int]:
        """The example range currently backing the device window."""
        if self._mode == "append" or self._seg is None:
            return (0, self.windows[0].n_valid)
        return self._seg

    # -------------------------------------------------------- observability
    @property
    def recorder(self):
        """EventRecorder for ``tier.*`` events; setting it also routes the
        ring's eviction instants (``obs.metrics.attach_dataset``)."""
        return self._recorder

    @recorder.setter
    def recorder(self, rec) -> None:
        self._recorder = rec
        self.ring.recorder = rec

    def _obs(self, name: str, **fields) -> None:
        if self._recorder is not None:
            self._recorder.instant(name, **fields)

    def _obs_occupancy(self) -> None:
        if self._recorder is None:
            return
        lo, hi = self.hot_range
        self._recorder.counter(
            "tier.occupancy", mode=self._mode, hot_lo=int(lo),
            hot_hi=int(hi), hot_rows=self.windows[0].n_valid,
            hot_cap=self.hot_cap, segments=max(1, len(self._segments)),
            ring_shards=self.ring.resident_shards,
            ring_bytes=self.ring.resident_bytes,
            resident_reuploads=self.tier_meter.resident_reuploads,
            staged_discards=self.tier_meter.staged_discards)

    # ----------------------------------------------------- staging machinery
    def _protect(self) -> None:
        ranges = [self.hot_range]
        if self._staged is not None:
            ranges.append((self._staged.lo, self._staged.hi))
        self.ring.protect(ranges)

    def _copy_job(self, lo: int, hi: int, landed):
        """The stager's job: rows [lo, hi) from the ring into fresh device
        buffers, one per field; on the card on the copy stream, ending in
        a recorded event the job waits on.  Before it allocates it waits
        on ``landed`` (the last commit's buffers going free), so the
        allocator hands it that memory back: the card then holds at most
        the hot window and one staged segment.  Returns (buffers, event)."""
        parts = self.ring.take_parts(lo, hi, hidden=True)
        if landed is not None:
            landed.synchronize()
        stream = self._copy_stream
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        event = None
        with ctx:
            bufs = tuple(
                torch.empty((hi - lo,) + w.item_shape, dtype=w.buffer.dtype,
                            device=self.device) for w in self.windows)
            try:
                for buf, field in zip(bufs, parts):
                    off = 0
                    for rows in field:
                        k = rows.shape[0]
                        buf[off:off + k].copy_(rows, non_blocking=True)
                        off += k
            finally:
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                    event.synchronize()
        return bufs, event

    def _stage_async(self, lo: int, hi: int, *, append: bool) -> None:
        """Hand rows [lo, hi) to the stager: ring fill (its blocking is
        hidden behind driver compute) then the copy to the device.  The
        result is landed — and only then metered — by ``_commit_staged``."""
        if self._staged is not None:
            raise RuntimeError("staging slot already occupied")
        self.ring.schedule(lo, hi)
        # protect the staged range BEFORE the job can run: a bounded ring
        # must not spill these shards out from under the stager
        self.ring.protect([self.hot_range, (lo, hi)])
        t0 = time.perf_counter()
        job = self._pool.submit(self._copy_job, lo, hi, self._landed)
        self._staged = _Staged(lo, hi, job, t0, append)
        self.tier_meter.staged_segments += 1
        self._protect()
        self._obs("tier.stage", lo=int(lo), hi=int(hi), append=bool(append))

    def _discard_staged(self) -> None:
        st, self._staged = self._staged, None
        if st is None:
            return
        if not st.future.cancel():
            try:                 # already running: drain, drop the result
                st.future.result()
            except Exception:
                pass             # a dead shard re-raises at the next build
        self.tier_meter.staged_discards += 1
        self._obs("tier.discard", lo=int(st.lo), hi=int(st.hi))

    def _land_staged(self, st: _Staged):
        """Wait for the stager's buffers and land them in the windows, on
        the card after the compute stream waits on the copies' event (the
        buffers are recorded on that stream, so the allocator reuses them
        only after the landing copies have run).  The buffers are freed on
        return.  Returns (seconds blocked, the compute stream or None)."""
        t0 = time.perf_counter()
        bufs, event = st.future.result()
        blocked = time.perf_counter() - t0
        st.future = None             # it holds the buffers too
        compute = None
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for buf in bufs:
                buf.record_stream(compute)
        if not st.append:
            for w in self.windows:
                w.restore_cursor({"n_valid": 0})
        for i, (w, rows) in enumerate(zip(self.windows, bufs)):
            w.append_staged(rows)
            self.meter.record_upload(
                nbytes=int(rows.nbytes),
                examples=(st.hi - st.lo) if i == 0 else 0)
        return blocked, compute

    def _commit_staged(self) -> None:
        """Land the staged rows (driver thread).  The wait here is the
        *unhidden* slice of staging time; upload metering happens now, so
        the meters only ever count segments that actually went hot."""
        st, self._staged = self._staged, None
        prev_lo, prev_hi = self.hot_range
        blocked, compute = self._land_staged(st)
        if compute is not None:
            self._landed = torch.cuda.Event()
            self._landed.record(compute)
        reup = max(0, min(st.hi, prev_hi) - max(st.lo, prev_lo))
        self.tier_meter.record_promotion(st.hi - st.lo, reuploaded=reup)
        self.tier_meter.staged_commits += 1
        self.tier_meter.stage_time_s += time.perf_counter() - st.t0
        self.tier_meter.commit_block_s += blocked
        if not st.append:
            self._seg = (st.lo, st.hi)
        self._protect()
        self._obs("tier.promote", lo=int(st.lo), hi=int(st.hi),
                  source="staged", examples=int(st.hi - st.lo),
                  blocked_s=round(blocked, 6))

    def _build_direct(self, lo: int, hi: int, *, reset: bool) -> None:
        """Synchronous driver-side promotion of [lo, hi) (cold start, plan
        miss, checkpoint rewarm).  ``reset`` replaces the hot segment;
        otherwise rows append after the resident prefix."""
        if hi <= lo:
            return
        rows = self.ring.take_rows(lo, hi)
        prev_lo, prev_hi = self.hot_range
        if reset:
            for w in self.windows:
                w.restore_cursor({"n_valid": 0})
        for w, r in zip(self.windows, rows):
            w.append(r.numpy())  # DeviceWindow meters this upload itself
        reup = max(0, min(hi, prev_hi) - max(lo, prev_lo))
        self.tier_meter.record_promotion(hi - lo, reuploaded=reup)
        self.tier_meter.direct_builds += 1
        if reset:
            self._seg = (lo, hi)
        self._protect()
        self._obs("tier.promote", lo=int(lo), hi=int(hi), source="direct",
                  examples=int(hi - lo))

    # --------------------------------------------------------- append regime
    def _round(self, n: int) -> int:
        """Shard-rounded residency target, clamped to corpus and budget."""
        size = self.stores[0].shard_size
        return min(self.n, self.hot_cap, -(-int(n) // size) * size)

    def _reconcile_append_staged(self) -> None:
        st = self._staged
        if st is None:
            return
        if st.append and st.lo == self.windows[0].n_valid:
            self._commit_staged()
        else:
            self._discard_staged()

    def _begin_append(self, n_t: int, n_next: int | None):
        self._reconcile_append_staged()
        if self._round(n_t) > self.windows[0].n_valid:
            self._build_direct(self.windows[0].n_valid, self._round(n_t),
                               reset=False)
        if n_next is not None and self._staged is None:
            nxt = self._round(n_next)       # clamps at hot_cap: when the
            # next stage rotates, this stages exactly the transition fill
            if nxt > self.windows[0].n_valid:
                self._stage_async(self.windows[0].n_valid, nxt, append=True)
        self._obs_occupancy()
        return self._view(n_t)

    def _view(self, n_t: int):
        views = tuple(w.slice(n_t) for w in self.windows)
        return views if len(views) > 1 else views[0]

    # ------------------------------------------------------- rotation regime
    def _view_seg(self):
        lo, hi = self._seg
        return self._view(hi - lo)

    def _begin_rotate(self, n_t: int):
        segs = self.manager.segments(n_t)
        idx = next((j for j, s in enumerate(segs) if s == self._seg), None)
        if idx is not None:
            # mid-sweep position survives the expansion (stride alignment
            # keeps full segments' ranges identical across stages)
            self._seg_idx = idx
            if self._staged is not None:
                want = segs[(idx + 1) % len(segs)]
                if (self._staged.lo, self._staged.hi) != want:
                    self._discard_staged()
        else:
            st = self._staged
            staged_at = None if st is None else next(
                (j for j, s in enumerate(segs) if (st.lo, st.hi) == s), None)
            if staged_at is not None:
                self._commit_staged()        # staged segment goes hot
                self._seg_idx = staged_at
            else:
                self._discard_staged()
                self._build_direct(*segs[0], reset=True)
                self._seg_idx = 0
        self._segments = segs
        self._plan = []
        if self._staged is None:
            nlo, nhi = segs[(self._seg_idx + 1) % len(segs)]
            self._stage_async(nlo, nhi, append=False)
        self._obs_occupancy()
        return self._view_seg()

    # ------------------------------------------------------------- protocol
    def begin_stage(self, n_t: int, n_next: int | None = None):
        """Engine stage setup: hot residency for the stage (or its first
        sweep segment), with the next expansion/segment already staging."""
        if not 0 < n_t <= self.n:
            raise ValueError(f"begin_stage({n_t}) outside corpus [1, {self.n}]")
        if self._mode == "append":
            if not self.manager.rotates(n_t):
                return self._begin_append(n_t, n_next)
            # append -> rotation transition: top the hot window up to
            # hot_cap append-only (the staged transition slice normally
            # makes this free); the full buffer then IS segment [0, cap)
            self._reconcile_append_staged()
            if self.hot_cap > self.windows[0].n_valid:
                self._build_direct(self.windows[0].n_valid, self.hot_cap,
                                   reset=False)
            self._mode = "rotate"
            self._seg = (0, self.hot_cap)
            self._seg_idx = 0
            self._obs("tier.rotate_begin", n_t=int(n_t),
                      hot_cap=self.hot_cap)
        return self._begin_rotate(n_t)

    def window(self, n_t: int):
        """Dataset protocol: the first n_t examples, device-resident.  Only
        meaningful while the range fits the hot window — a full-corpus
        fallback view is exactly what tiering exists to avoid."""
        if self._mode == "rotate" or self.manager.rotates(n_t):
            raise RuntimeError(
                f"TieredCorpus.window({n_t}) needs the whole range hot but "
                f"the HBM budget holds {self.hot_cap} rows; pass eval_data "
                f"to the engine (the session's eval probe does) instead of "
                f"falling back to a full-window view")
        return self._begin_append(n_t, None)

    def segment_steps(self, n_t: int, k: int) -> list[tuple[int, int | None]]:
        """Split a chunk of ``k`` inner steps over the stage's sweep:
        ``[(steps, examples_per_step), ...]`` in visit order, first entry
        always the currently hot segment.  Consecutive segments from the
        current sweep position share the steps as evenly as possible;
        segments with zero steps are skipped.  The non-rotating regimes
        return one entry with ``None`` cost (the engine charges ``n_t``)."""
        if self._mode != "rotate" or k <= 0:
            return [(k, None)]
        segs, S = self._segments, len(self._segments)
        base, extra = divmod(int(k), S)
        entries = [((self._seg_idx + j) % S, base + (1 if j < extra else 0))
                   for j in range(S)]
        entries = [(si, kj) for si, kj in entries if kj]
        self._plan = [si for si, _ in entries[1:]]
        return [(kj, segs[si][1] - segs[si][0]) for si, kj in entries]

    def advance_window(self):
        """Commit the next planned sweep segment as the hot window and
        return its view (staged hit: one in-place landing; miss: a
        synchronous rebuild, counted in ``TierMeter.direct_builds``).
        Immediately stages the segment after — the wrap segment when the
        plan ends, which is also the next stage's first segment."""
        if self._mode != "rotate" or not self._plan:
            raise RuntimeError(
                "advance_window without a planned segment (plans come from "
                "segment_steps; only the rotation regime has them)")
        si = self._plan.pop(0)
        target = self._segments[si]
        if self._staged is not None and \
                (self._staged.lo, self._staged.hi) == target:
            self._commit_staged()
        else:
            self._discard_staged()
            self._build_direct(*target, reset=True)
        self._seg_idx = si
        nxt = self._segments[self._plan[0]] if self._plan else \
            self._segments[(si + 1) % len(self._segments)]
        if self._staged is None and nxt != target:
            self._stage_async(nxt[0], nxt[1], append=False)
        self._obs_occupancy()
        return self._view_seg()

    def note_access(self, examples: int) -> None:
        self.meter.record_access(examples)

    # ------------------------------------------------------------ reporting
    def tier_report(self) -> dict:
        """Tier-plane summary for ``trace.meta['tiers']`` / benchmarks."""
        lo, hi = self.hot_range
        return {"mode": self._mode, "hot_cap": self.hot_cap,
                "hot_range": [int(lo), int(hi)],
                "segments": max(1, len(self._segments)),
                "ring_shards": self.ring.resident_shards,
                "ring_bytes": self.ring.resident_bytes,
                "meter": self.tier_meter.snapshot()}

    # ----------------------------------------------------------- checkpoint
    def tier_state(self) -> dict:
        """Checkpointable tier cursor: with the fixed permutation, mode +
        hot range fully determine the hot window's contents — a restore
        re-reads at most ``hot_cap`` rows, never the whole corpus."""
        lo, hi = self.hot_range
        return {"mode": self._mode, "hot_lo": int(lo), "hot_hi": int(hi),
                "seg_idx": int(self._seg_idx),
                "meter": self.tier_meter.snapshot()}

    def restore_tier(self, state: dict) -> dict:
        """Re-land exactly the checkpointed hot window (recovery I/O is
        bounded by the HBM budget).  Meters are *not* restored here — the
        checkpoint layer captures this rewarm I/O separately first, per the
        resume accounting convention."""
        self._discard_staged()
        lo, hi = int(state["hot_lo"]), int(state["hot_hi"])
        for w in self.windows:
            w.restore_cursor({"n_valid": 0})
        self._seg = None
        self._segments, self._plan = [], []
        self._mode = str(state.get("mode", "append"))
        if self._mode == "append":
            self._build_direct(0, hi, reset=False)
        else:
            self._build_direct(lo, hi, reset=True)
            self._seg_idx = int(state.get("seg_idx", 0))
        return {"rewarm_examples": hi - lo if self._mode == "rotate" else hi}

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        st, self._staged = self._staged, None
        if st is not None:
            st.future.cancel()
        self._pool.shutdown(wait=True, cancel_futures=True)
        self.prefetcher.close()

    def __enter__(self) -> "TieredCorpus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
