"""Online ingestion: an append-only ShardStore fed by the serving path —
the port's copy of ``repro.serve.ingest`` (numpy, line for line).

BET's window only ever grows over one fixed permutation, so a corpus that
*arrives over time* — the log of live requests, in arrival order — is the
degenerate-permutation case the theory already covers: ingestion is pure
append, never reshuffle, never resample.  ``OnlineShardStore`` is the
storage half of that claim: logged examples buffer in a host-side tail and
are *sealed* into full fixed-size shards as they accumulate.

Contract with the rest of the plane:

  * ``num_examples`` counts **sealed** examples only.  Every visible shard
    is exactly ``shard_size`` rows, so the base-class shard arithmetic
    (``examples_in``, ``shards_covering``) holds at every instant, and a
    shard, once visible, is immutable — the Prefetcher may load it from a
    worker thread while the serving thread appends.
  * ``capacity`` bounds the eventual corpus.  ``DeviceWindow`` and
    ``ShardOwnership`` size themselves from it (via
    ``repro_torch.data.shards.store_capacity``), so residency and the
    ownership prefix invariant extend to a corpus whose true size is
    discovered at runtime.
  * ``close()`` seals the ragged tail (the one place a short shard is
    allowed — as the *last* shard, matching the base contract) and freezes
    the store; a closed store is indistinguishable from an offline one.
"""
from __future__ import annotations

import threading

import numpy as np

from ..data.shards import ShardStore


class OnlineShardStore(ShardStore):
    """Append-only shard store over a corpus still arriving.

    ``append`` is called from the serving thread; ``load`` from prefetch
    workers.  A lock guards the sealed-shard list and the counters — loads
    copy out under the lock, appends seal under it, so readers never see a
    half-sealed shard.
    """

    def __init__(self, item_shape, dtype, *, shard_size: int, capacity: int):
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.shard_size = int(shard_size)
        self.capacity = int(capacity)
        self.item_shape = tuple(int(d) for d in item_shape)
        self.dtype = np.dtype(dtype)
        self.closed = False
        self._lock = threading.Lock()
        self._shards: list[np.ndarray] = []   # sealed, immutable
        self._tail: list[np.ndarray] = []     # unsealed rows, arrival order
        self._tail_rows = 0
        self._sealed = 0                      # sealed example count

    # ------------------------------------------------------------- queries
    @property
    def num_examples(self) -> int:           # dynamic: grows as shards seal
        return self._sealed

    @property
    def total_logged(self) -> int:
        """Sealed + still-buffered rows (the true arrival count)."""
        with self._lock:
            return self._sealed + self._tail_rows

    # ------------------------------------------------------------ mutation
    def append(self, rows: np.ndarray) -> int:
        """Log ``rows`` (arrival order == permutation order); seal any full
        shards.  Returns the new sealed ``num_examples``."""
        rows = np.asarray(rows, dtype=self.dtype)
        if rows.ndim == len(self.item_shape):   # single example
            rows = rows[None]
        if tuple(rows.shape[1:]) != self.item_shape:
            raise ValueError(
                f"row shape {tuple(rows.shape[1:])} != item_shape "
                f"{self.item_shape}")
        with self._lock:
            if self.closed:
                raise RuntimeError("append() on a closed OnlineShardStore")
            if self._sealed + self._tail_rows + len(rows) > self.capacity:
                raise ValueError(
                    f"append of {len(rows)} rows overflows capacity "
                    f"{self.capacity} (have {self._sealed + self._tail_rows})")
            self._tail.append(np.array(rows))
            self._tail_rows += len(rows)
            self._seal_full_locked()
            return self._sealed

    def _seal_full_locked(self) -> None:
        while self._tail_rows >= self.shard_size:
            buf = np.concatenate(self._tail, axis=0)
            self._shards.append(np.ascontiguousarray(buf[:self.shard_size]))
            rest = buf[self.shard_size:]
            self._tail = [rest] if len(rest) else []
            self._tail_rows = len(rest)
            self._sealed += self.shard_size

    def close(self) -> int:
        """Seal the ragged tail as the final shard and freeze the store.
        Idempotent; returns the final ``num_examples``."""
        with self._lock:
            if not self.closed:
                self.closed = True
                if self._tail_rows:
                    buf = np.concatenate(self._tail, axis=0)
                    self._shards.append(np.ascontiguousarray(buf))
                    self._sealed += self._tail_rows
                    self._tail, self._tail_rows = [], 0
            return self._sealed

    # -------------------------------------------------------------- reads
    def load(self, shard: int) -> np.ndarray:
        with self._lock:
            n_shards = len(self._shards)
            if not 0 <= shard < n_shards:
                raise IndexError(
                    f"shard {shard} not sealed yet ({n_shards} available)")
            return np.array(self._shards[shard])

    def prefix(self, n: int) -> np.ndarray:
        """First ``n`` sealed examples as one array (eval probes, tests)."""
        with self._lock:
            if n > self._sealed:
                raise ValueError(f"prefix({n}) > sealed {self._sealed}")
            if n == 0:
                return np.empty((0,) + self.item_shape, dtype=self.dtype)
            out = np.concatenate(self._shards, axis=0)[:n]
            return np.array(out)
