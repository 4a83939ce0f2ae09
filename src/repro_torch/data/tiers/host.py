"""HostRing — the host-RAM spill tier between disk shards and HBM; the
port of ``repro.data.tiers.host``.

Every shard the :class:`~repro_torch.data.prefetch.Prefetcher` delivers is
retained here, keyed by shard id, so rotation re-promotions are host-RAM
hits instead of disk re-reads: with the default unbounded ring, each
example leaves storage exactly once per run no matter how many sweeps the
hot window makes over it (the BENCH_scale ``each_example_loaded_once``
claim).  A ``host_bytes`` budget turns the ring into a FIFO cache —
oldest shards spill first, *protected* shards (the ones backing the
current and staged hot segments) are never evicted, and a later touch of
an evicted shard is a fresh disk read, metered as such.

The ring holds each shard as host tensors, one per field.  With
``pin=True`` (a corpus on the card) they are copied into pinned memory as
they enter, so a promotion's host-to-device copies run asynchronously on
the corpus's copy stream; without it they share the loaded arrays' memory.

Thread contract: the driver thread and the corpus's one staging thread
both call in; a single lock serializes shard-map mutation *and* the
prefetcher takes, so the ``DataAccessMeter``'s load counters are only
ever updated from one thread at a time.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ..prefetch import Prefetcher
from ..shards import ShardStore
from .manager import TierMeter


class HostRing:
    """Host-RAM shard cache over a prefetcher, with budgeted FIFO spill."""

    def __init__(self, stores: Sequence[ShardStore],
                 prefetcher: Prefetcher, *, host_bytes: int = 0,
                 tier_meter: TierMeter | None = None, pin: bool = False):
        if host_bytes < 0:
            raise ValueError(f"host_bytes must be >= 0 (0 = unbounded), "
                             f"got {host_bytes}")
        self.stores = tuple(stores)
        self.prefetcher = prefetcher
        self.host_bytes = int(host_bytes)
        self.tier_meter = tier_meter
        self.pin = bool(pin)
        self._shards: dict[int, tuple[torch.Tensor, ...]] = {}
        self._order: list[int] = []          # arrival order (FIFO spill)
        self._bytes = 0
        self._protected: set[int] = set()
        self._pinned: set[int] = set()       # mid-take ranges, never spilled
        self._lock = threading.RLock()
        # observability: tier.evict instants when wired (obs.metrics)
        self.recorder = None

    # -------------------------------------------------------------- queries
    @property
    def resident_shards(self) -> int:
        with self._lock:
            return len(self._shards)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def shards_for(self, lo: int, hi: int) -> range:
        """Shard ids covering example range ``[lo, hi)``."""
        size = self.stores[0].shard_size
        return range(lo // size, -(-hi // size)) if hi > lo else range(0)

    # ------------------------------------------------------------ residency
    def schedule(self, lo: int, hi: int) -> None:
        """Background-load the shards covering ``[lo, hi)`` that are not
        already ringed — the overlap hint a staging pass issues before the
        driver goes back to computing."""
        with self._lock:
            missing = [i for i in self.shards_for(lo, hi)
                       if i not in self._shards]
        if missing:
            self.prefetcher.schedule(missing)

    def take_parts(self, lo: int, hi: int, *, hidden: bool = False
                   ) -> tuple[list[torch.Tensor], ...]:
        """Rows ``[lo, hi)`` as, per field store, the in-order row slices of
        the ring's shards (views, no copy), pulling any missing shards
        through the prefetcher (blocking).  ``hidden=True`` marks the waits
        as overlapped (the staging-thread path: its blocking is by
        construction concurrent with driver compute).  Newly pulled shards
        enter the ring; the budget may spill *unprotected* ones (a slice
        handed out keeps its shard's memory alive)."""
        size = self.stores[0].shard_size
        ids = list(self.shards_for(lo, hi))
        parts: tuple[list[torch.Tensor], ...] = tuple([] for _ in self.stores)
        with self._lock:
            # pin the whole range for the duration: a tight budget must not
            # spill shard i while shard j > i of the *same take* is landing
            self._pinned.update(ids)
            try:
                for i in ids:
                    if i not in self._shards:
                        self._insert_locked(i, self.prefetcher.take(
                            i, hidden=hidden))
                for i in ids:
                    fields = self._shards[i]
                    a = max(lo - i * size, 0)
                    b = min(hi - i * size, fields[0].shape[0])
                    for acc, rows in zip(parts, fields):
                        acc.append(rows[a:b])
            finally:
                self._pinned.difference_update(ids)
                self._spill_locked()         # re-apply the budget unpinned
        return parts

    def take_rows(self, lo: int, hi: int, *, hidden: bool = False
                  ) -> tuple[torch.Tensor, ...]:
        """Rows ``[lo, hi)`` as one host tensor per field store (the
        reference's ``take_rows``; see :meth:`take_parts`)."""
        return tuple(p[0] if len(p) == 1 else torch.cat(p)
                     for p in self.take_parts(lo, hi, hidden=hidden))

    def protect(self, ranges) -> None:
        """Pin the shards backing ``ranges`` (``(lo, hi)`` pairs) against
        spill — the current hot segment and the one being staged must stay
        promotable without a disk round-trip."""
        keep: set[int] = set()
        for lo, hi in ranges:
            keep.update(self.shards_for(lo, hi))
        with self._lock:
            self._protected = keep
            self._spill_locked()

    # ------------------------------------------------------------ internals
    def _host(self, rows: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.require(rows, requirements=["C", "W"]))
        return t.pin_memory() if self.pin else t

    def _insert_locked(self, shard: int, arrays: tuple[np.ndarray, ...]):
        fields = tuple(self._host(a) for a in arrays)
        self._shards[shard] = fields
        self._order.append(shard)
        self._bytes += sum(t.nbytes for t in fields)
        self._spill_locked()

    def _spill_locked(self) -> None:
        if not self.host_bytes:
            return                            # unbounded ring
        i = 0
        while self._bytes > self.host_bytes and i < len(self._order):
            cand = self._order[i]
            if cand in self._protected or cand in self._pinned:
                i += 1
                continue
            fields = self._shards.pop(cand)
            self._order.pop(i)
            self._bytes -= sum(t.nbytes for t in fields)
            examples = int(fields[0].shape[0])
            if self.tier_meter is not None:
                self.tier_meter.record_eviction(examples)
            if self.recorder is not None:
                self.recorder.instant("tier.evict", shard=int(cand),
                                      examples=examples,
                                      ring_bytes=self._bytes)
