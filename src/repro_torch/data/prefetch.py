"""Background shard prefetching — the paper's load/compute overlap, for
real; the port's copy of ``repro.data.prefetch``.

§3.3: while the optimizer runs stage t on the resident window, the shards
for stage t+1 stream in concurrently.  ``Prefetcher`` realizes that with a
small thread pool: the data plane *schedules* the next stage's shards when a
stage begins, device computation proceeds, and when the expansion finally
*takes* a shard the load has (ideally) already finished.  The demand-side
wait is what the ``DataAccessMeter`` records as ``blocked_time_s`` — zero
blocked time means the loads were fully hidden.

A prefetcher serves one or more *field* stores in lockstep (e.g. the convex
path's X and y): shard i is one unit covering the same example range in
every store, so residency bookkeeping stays scalar.

Failure contract: a background load that raises does **not** stay hidden
until its own ``take`` — every subsequent ``schedule``/``take`` call first
re-raises the failure as ``ShardLoadError`` (original exception chained),
so the driving thread learns about a dead storage path at the next stage
boundary instead of one expansion later.  A failed load puts its shard on
a list before its future completes, so that check reads only the failures,
not every pending load (the reference scans all of them on every call,
which costs an S-shard expansion S²/2 checks).

With a ``recorder`` attached (``obs.metrics.attach_prefetcher``) each
schedule, load, land and cancel emits one event, as in the reference
(``prefetch.loaded`` from the worker thread), with a ``prefetch.depth``
counter of the in-flight loads.  The reference's ``max_inflight`` backlog
serves only the tiered corpus and comes with it (ROADMAP queue A11); the
depth counter's ``backlog`` is therefore always 0 here.
The loads themselves are numpy, as in the reference: the plane's
``DeviceWindow`` puts the rows on the card.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from typing import Sequence

import numpy as np

# ShardLoadError lives with the stores (MemmapShardStore raises it for
# corrupt files too); re-exported here, where the failure contract is
from .shards import DataAccessMeter, ShardLoadError, ShardStore

__all__ = ["Prefetcher", "ShardLoadError"]


class Prefetcher:
    """Asynchronous loader over parallel shard stores.

    ``schedule`` / ``take`` are called from the driving thread only; worker
    threads just execute loads.  Taking an unscheduled shard degrades to a
    synchronous (fully blocked) demand load, so correctness never depends on
    the prefetch horizon.

    ``max_workers`` defaults to 1 — the paper's sequential-loading channel
    (§4.2's rate ``a``), and what keeps ``DataAccessMeter.overlap_fraction``
    honest: with one worker, load time can only hide behind *computation*.
    More workers raise throughput but also let loads hide behind each
    other, inflating the overlap metric with IO-IO parallelism.

    ``close`` is idempotent and safe against a concurrent ``schedule`` (the
    teardown race when an engine thread is still prefetching while the owner
    shuts the plane down): whichever side takes the lock second wins nothing
    — a post-close ``schedule`` is a silent no-op, and only a post-close
    ``take`` raises, because dropping a demand load is a correctness error
    while dropping a prefetch hint is not."""

    def __init__(self, stores: Sequence[ShardStore],
                 meter: DataAccessMeter | None = None, *, max_workers: int = 1):
        stores = tuple(stores)
        if not stores:
            raise ValueError("Prefetcher needs at least one store")
        sizes = {(s.num_examples, s.shard_size) for s in stores}
        if len(sizes) != 1:
            raise ValueError(
                f"field stores disagree on (num_examples, shard_size): {sizes}")
        self.stores = stores
        self.meter = meter
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="bet-prefetch")
        # shard -> (ticket, future) of each scheduled, not yet taken load
        self._pending: dict[int, tuple[int, Future]] = {}
        self._tickets = itertools.count()
        # (shard, ticket) of scheduled loads that raised, in the order they
        # failed: appended by the worker (deque appends are atomic) before
        # the future completes, drained by the driving thread under the lock
        self._failed: deque[tuple[int, int]] = deque()
        self._lock = threading.Lock()
        self._closed = False
        # observability: when wired, schedule/load/land/cancel each emit
        # one event; prefetch.loaded fires on the worker thread,
        # interleaved with the driving thread's events in ``seq`` order
        self.recorder = None
        self.recorder_tags: dict = {}

    def _obs(self, name: str, **fields) -> None:
        rec = self.recorder
        if rec is not None:
            rec.instant(name, tags=self.recorder_tags or None, **fields)

    def _obs_depth(self, inflight: int) -> None:
        rec = self.recorder
        if rec is not None:
            rec.counter("prefetch.depth", tags=self.recorder_tags or None,
                        inflight=inflight, backlog=0)

    # ------------------------------------------------------------------ api
    def schedule(self, shard_ids) -> None:
        """Begin loading shards in the background (idempotent per shard).
        No-op after ``close``; raises ``ShardLoadError`` eagerly if any
        previously scheduled load has already failed."""
        with self._lock:
            if self._closed:
                return
            self._sweep_failures_locked()
            new_ids = []
            for i in shard_ids:
                if i not in self._pending:
                    t = next(self._tickets)
                    self._pending[i] = (
                        t, self._pool.submit(self._timed_load, i, t))
                    new_ids.append(i)
            inflight = len(self._pending)
        for i in new_ids:        # emit outside the lock
            self._obs("prefetch.scheduled", shard=int(i))
        if new_ids:
            self._obs_depth(inflight)

    def cancel(self, shard_ids) -> list[int]:
        """Drop scheduled loads whose shards no longer belong here (elastic
        ownership migration, lane rebuild).  Queued futures are cancelled;
        loads already running cannot be interrupted, so their futures are
        *dropped* instead — the result (possibly read through a stale
        local→global mapping) is discarded, never landed at a window offset
        it no longer corresponds to, and never metered.  Returns the local
        shard ids that were actually pending.  No-op after ``close``."""
        with self._lock:
            if self._closed:
                return []
            dropped = []
            for i in list(shard_ids):
                entry = self._pending.pop(i, None)
                if entry is not None:
                    entry[1].cancel()
                    dropped.append(i)
            inflight = len(self._pending)
        for i in dropped:
            self._obs("prefetch.cancelled", shard=int(i))
        if dropped:
            self._obs_depth(inflight)
        return dropped

    def scheduled(self) -> list[int]:
        """All shards currently scheduled (not yet taken)."""
        with self._lock:
            return sorted(self._pending)

    def unfinished(self) -> list[int]:
        """Scheduled shards whose loads have not completed yet — the
        straggler detector's backlog measure at a stage flush."""
        with self._lock:
            return sorted(i for i, (_, fut) in self._pending.items()
                          if not fut.done())

    def inflight(self) -> int:
        """Scheduled-but-not-taken loads (loaded shards hold their arrays
        in host RAM until taken)."""
        with self._lock:
            return len(self._pending)

    def take(self, shard: int, *, hidden: bool = False
             ) -> tuple[np.ndarray, ...]:
        """Block until ``shard`` is loaded and return one array per store.

        ``hidden=True`` records the wait as fully overlapped
        (``blocked_s=0``): the tiered corpus consumes shards on a
        background staging thread whose blocking is by construction
        concurrent with driver compute, and charging it as demand-side
        blocked time would misreport the §3.3 overlap."""
        with self._lock:
            self._check_open()
            self._sweep_failures_locked()
            entry = self._pending.pop(shard, None)
            prefetched = entry is not None
            fut = entry[1] if prefetched else self._pool.submit(
                self._timed_load, shard, None)
        t0 = time.perf_counter()
        try:
            arrays, duration = fut.result()
        except CancelledError:
            # a close() racing this take cancelled the queued load —
            # CancelledError is a BaseException, so name the race instead
            # of letting it escape raw (the documented post-close contract)
            raise RuntimeError(
                f"Prefetcher closed while shard {shard} was in flight") \
                from None
        except Exception as exc:
            raise ShardLoadError(shard, exc) from exc
        blocked = 0.0 if hidden else time.perf_counter() - t0
        if self.meter is not None:
            self.meter.record_load(
                nbytes=sum(a.nbytes for a in arrays),
                examples=self.stores[0].examples_in(shard),
                duration_s=duration, blocked_s=blocked, prefetched=prefetched)
        self._obs("prefetch.landed", shard=int(shard),
                  prefetched=prefetched, blocked_s=blocked,
                  duration_s=duration)
        return arrays

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = dict(self._pending)
            self._pending.clear()
        # shut down outside the lock: workers may take a while to drain and
        # a racing schedule()/take() must not block on them
        for _, fut in pending.values():
            fut.cancel()
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- internals
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("Prefetcher is closed")

    def _sweep_failures_locked(self) -> None:
        """Surface an already-failed background load now (caller holds the
        lock).  The failed future is dropped so a retry can be rescheduled;
        a failure whose load was since taken or cancelled is discarded (its
        ``take`` raises it, or nobody wants it).  A listed load's worker is
        already raising, so waiting on its future returns at once."""
        while self._failed:
            i, t = self._failed.popleft()
            entry = self._pending.get(i)
            if entry is not None and entry[0] == t:
                del self._pending[i]
                exc = entry[1].exception()
                raise ShardLoadError(i, exc) from exc

    def _timed_load(self, shard: int, ticket: int | None):
        """Load one shard from every store; ``ticket`` is None for a demand
        load, which its own ``take`` waits on."""
        t0 = time.perf_counter()
        try:
            arrays = tuple(s.load(shard) for s in self.stores)
        except Exception:
            if ticket is not None:
                self._failed.append((shard, ticket))
            raise
        duration = time.perf_counter() - t0
        # worker-thread emission: lands after the shard's
        # prefetch.scheduled and before its prefetch.landed
        self._obs("prefetch.loaded", shard=int(shard), duration_s=duration)
        return arrays, duration
