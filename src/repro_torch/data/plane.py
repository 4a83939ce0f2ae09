"""StreamingDataset — the engine-facing streaming data plane; the port of
``repro.data.plane`` for one host.

Composes the three plane primitives into the dataset protocol that
``BetEngine`` drives:

    ShardStore(s)  --Prefetcher-->  host shards  --append-->  DeviceWindow(s)

  * ``window(n_t)``              — dataset protocol: ensure the first n_t
    examples are device-resident and return the stage view,
  * ``begin_stage(n_t, n_next)`` — the engine's stage setup: residency for
    the current stage, then *schedule* the next stage's shards so their
    loads overlap with this stage's computation (§3.3),
  * ``note_access(k)``           — the engine reports optimizer touches so
    ``DataAccessMeter`` mirrors the simulated clock's access accounting
    with real-I/O load numbers next to it (Thm 4.1).

Views: ``masked=True`` serves a ``MaskedWindow`` (the LM path);
``masked=False`` serves device-side prefix views, one per field store (the
convex ``(X, y)`` path, bit-exact against the host path's slices).

``windows=`` hands the plane caller-made windows instead: the multi-host
runtime gives each host's plane the ``WindowLane``s of the shared
``StackedDeviceWindow`` (``dist/runtime.py``).  The reference's
``shardings=`` places the windows with a JAX ``NamedSharding`` and has no
counterpart here: a window lives on the device it is made on (the
topology's, for the multi-host lanes).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .device_window import DeviceWindow
from .prefetch import Prefetcher
from .shards import (DataAccessMeter, InMemoryShardStore, ShardStore,
                     store_capacity)


class StreamingDataset:
    """Device-resident expanding windows over sharded storage."""

    def __init__(self, stores: Sequence[ShardStore], *, masked: bool = False,
                 meter: DataAccessMeter | None = None, growth: float = 2.0,
                 prefetch_workers: int = 1, device="cuda",
                 windows: Sequence | None = None, shardings=None):
        if shardings is not None:
            raise NotImplementedError(
                "StreamingDataset shardings= is a JAX NamedSharding and has "
                "no counterpart in repro_torch: a window lives on the device "
                "it is made on (device=, or the topology's device for the "
                "multi-host lanes given as windows=)")
        stores = tuple(stores)
        if masked and len(stores) != 1:
            raise ValueError("masked mode serves a single field store")
        self.stores = stores
        self.masked = masked
        self.meter = meter if meter is not None else DataAccessMeter()
        # the windows first: a bad device or growth must not leave a
        # prefetcher's thread pool behind
        if windows is not None:
            # caller-made windows (a WindowLane of the shared stacked
            # window per field) own their upload metering
            windows = tuple(windows)
            if len(windows) != len(stores):
                raise ValueError(
                    f"{len(windows)} windows for {len(stores)} field stores")
            self.windows = windows
        else:
            self.windows = tuple(
                DeviceWindow(capacity=store_capacity(s),
                             item_shape=s.item_shape, dtype=s.dtype,
                             growth=growth, meter=self.meter,
                             meter_examples=i == 0, device=device)
                for i, s in enumerate(stores))
        self.prefetcher = Prefetcher(stores, self.meter,
                                     max_workers=prefetch_workers)
        self._next_shard = 0

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_arrays(cls, arrays, shard_size: int, **kw) -> "StreamingDataset":
        """In-memory plane over pre-permuted field arrays (X, y) / (tokens,)."""
        if isinstance(arrays, np.ndarray) or not isinstance(arrays,
                                                            (tuple, list)):
            arrays = (arrays,)
        stores = [InMemoryShardStore(np.asarray(a), shard_size)
                  for a in arrays]
        return cls(stores, **kw)

    # ---------------------------------------------------------------- protocol
    @property
    def n(self) -> int:
        return self.stores[0].num_examples

    @property
    def d(self) -> int:
        """Feature dimension of the first field (the convex path's X)."""
        return self.stores[0].item_shape[0]

    @property
    def resident(self) -> int:
        """Examples currently resident on device (shard-rounded >= n_t)."""
        return self.windows[0].n_valid

    def ensure_resident(self, n_t: int) -> int:
        """Take shards (blocking on any still in flight) until the first
        ``n_t`` examples are device-resident.  All newly-taken shards land
        in one coalesced append per field — one copy per expansion instead
        of one per shard."""
        store = self.stores[0]
        need = store.shards_covering(n_t).stop
        if self._next_shard >= need:
            return self.resident
        # schedule everything still missing before blocking on the first
        # take, so cold starts pipeline across the worker pool too
        self.prefetcher.schedule(range(self._next_shard, need))
        chunks = [[] for _ in self.stores]
        try:
            while self._next_shard < need:
                arrays = self.prefetcher.take(self._next_shard)
                for acc, rows in zip(chunks, arrays):
                    acc.append(rows)
                self._next_shard += 1
        finally:
            # land whatever was taken even when a later take raises
            # (ShardLoadError mid-expansion): _next_shard must never run
            # ahead of appended rows, or a retried call would append later
            # shards at the failed shards' window offsets
            for win, acc in zip(self.windows, chunks):
                if acc:
                    win.append(acc[0] if len(acc) == 1
                               else np.concatenate(acc))
        return self.resident

    def prefetch(self, n: int) -> None:
        """Schedule background loads so the first ``n`` examples will be
        takeable without blocking (the next stage's shards)."""
        need = self.stores[0].shards_covering(n)
        self.prefetcher.schedule(range(self._next_shard, need.stop))

    def begin_stage(self, n_t: int, n_next: int | None = None):
        """Engine stage setup: make the stage window resident, overlap the
        *next* expansion's loads with this stage's compute, return the view."""
        self.ensure_resident(n_t)
        if n_next is None:
            n_next = self.windows[0].next_size()
        self.prefetch(n_next)
        return self._view(n_t)

    def window(self, n_t: int):
        """Dataset protocol: the first n_t examples, device-resident."""
        self.ensure_resident(n_t)
        return self._view(n_t)

    def note_access(self, examples: int) -> None:
        self.meter.record_access(examples)

    # -------------------------------------------------------------- residency
    @property
    def next_shard(self) -> int:
        """First shard not yet landed in the window."""
        return self._next_shard

    def pending_shards(self) -> list[int]:
        """Scheduled-but-unfinished shard ids (the load backlog)."""
        return self.prefetcher.unfinished()

    def drop_pending(self, min_local_shard: int) -> list[int]:
        """Cancel every pending prefetch at or beyond ``min_local_shard``.
        Landed shards (``< next_shard``) are never touched: a load may be
        dropped only beyond the resident prefix."""
        if min_local_shard < self._next_shard:
            raise ValueError(
                f"cannot drop pending loads from local shard "
                f"{min_local_shard}: shards below {self._next_shard} are "
                f"already landed in the window")
        stale = [i for i in self.prefetcher.scheduled()
                 if i >= min_local_shard]
        return self.prefetcher.cancel(stale)

    # ------------------------------------------------------------------ misc
    def _view(self, n_t: int):
        if self.masked:
            return self.windows[0].masked(n_t)
        views = tuple(w.slice(n_t) for w in self.windows)
        return views if len(views) > 1 else views[0]

    def close(self) -> None:
        self.prefetcher.close()

    def __enter__(self) -> "StreamingDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
