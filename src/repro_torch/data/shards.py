"""Shard stores — the storage layer of the streaming data plane; the
port's copy of ``repro.data.shards``, line for line.

BET's resource model (§3.3) assumes the training corpus is pre-permuted and
split into fixed-size *shards* (files on NAS, host-local slices of a cloud
dataset).  The optimizer at stage t touches only the first n_t examples of
the permutation, so shards are consumed strictly in order, each is loaded
exactly once, and loading of the next stage's shards can overlap with
computation on the resident window.

This module provides the storage side of that contract:

  * ``MemmapShardStore``   — one ``.npy`` file per shard, read through
                             ``np.memmap`` (the production layout),
  * ``InMemoryShardStore`` — the same interface over a resident array
                             (tests, synthetic corpora),
  * ``ThrottledStore``     — wraps any store with a per-shard read latency,
                             modelling a constrained NAS / object store so
                             load/compute overlap is measurable at CI scale,
  * ``DataAccessMeter``    — counts bytes/examples loaded vs reused and the
                             blocked-vs-hidden load time, so Thm 4.1's
                             O(1/ε) data-access accounting comes from real
                             reads instead of only the simulated clock.

Kept numpy-only, as in the reference: a corpus written by either package
(``MemmapShardStore.write``) opens in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np


class ShardLoadError(RuntimeError):
    """A shard load failed (truncated/corrupt file, dead storage path);
    the original exception, when there is one, is chained."""

    def __init__(self, shard: int, cause: BaseException | str):
        detail = cause if isinstance(cause, str) else repr(cause)
        super().__init__(f"shard {shard} failed to load: {detail}")
        self.shard = shard


def store_capacity(store) -> int:
    """The number of examples a store will eventually hold.

    Offline stores are fixed at ``num_examples``; an online store
    (serve/ingest.py) reports only *sealed* examples there but bounds the
    eventual corpus with a ``capacity`` attribute.  Residency preallocation
    (``DeviceWindow``), the ownership prefix map (``ShardOwnership``) and the
    tier planner all size themselves from this one answer."""
    return int(getattr(store, "capacity", store.num_examples))


# ------------------------------------------------------------------ metering
@dataclasses.dataclass
class DataAccessMeter:
    """Real-I/O counters for the §3.3 resource claims.

    *Loads* are storage reads (shard granularity).  *Uploads* are
    host→device transfers of example payload.  *Accesses* are optimizer
    touches of resident examples (one batch update on a window of n charges
    n, mirroring ``SimulatedClock.data_accesses``).  ``blocked_time_s`` is
    the demand-side time spent waiting for a load that compute could not
    hide — the complement of the paper's load/compute overlap."""
    bytes_loaded: int = 0
    examples_loaded: int = 0
    loads: int = 0
    prefetched_loads: int = 0
    load_time_s: float = 0.0
    blocked_time_s: float = 0.0
    bytes_uploaded: int = 0
    examples_uploaded: int = 0
    uploads: int = 0
    examples_accessed: int = 0

    def record_load(self, *, nbytes: int, examples: int, duration_s: float,
                    blocked_s: float, prefetched: bool) -> None:
        self.bytes_loaded += int(nbytes)
        self.examples_loaded += int(examples)
        self.loads += 1
        self.prefetched_loads += int(bool(prefetched))
        self.load_time_s += float(duration_s)
        self.blocked_time_s += float(blocked_s)

    def record_upload(self, *, nbytes: int, examples: int) -> None:
        self.bytes_uploaded += int(nbytes)
        self.examples_uploaded += int(examples)
        self.uploads += 1

    def record_access(self, examples: int) -> None:
        self.examples_accessed += int(examples)

    @property
    def overlap_fraction(self) -> float:
        """Fraction of storage-read time the demand side did not wait for.
        With a single prefetch worker (the default sequential load channel)
        this is exactly the §3.3 load/compute overlap; with more workers,
        loads also hide behind each other and the figure reads higher.
        When loads were recorded without timing (e.g. the ExpandingWindow
        shim's zero-duration loads) nothing was measured as hidden — report
        0, not a fabricated perfect overlap."""
        if self.load_time_s <= 0.0:
            return 1.0 if self.loads == 0 else 0.0
        return max(0.0, min(1.0, 1.0 - self.blocked_time_s / self.load_time_s))

    @property
    def reuse_ratio(self) -> float:
        """Optimizer touches per unique example loaded — BET reuses resident
        data across inner steps, so this grows with κ̂ while loads stay N."""
        return self.examples_accessed / max(1, self.examples_loaded)

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["overlap_fraction"] = round(self.overlap_fraction, 4)
        d["reuse_ratio"] = round(self.reuse_ratio, 2)
        return d

    def restore(self, snap: dict) -> None:
        """Inverse of ``snapshot`` (derived keys ignored): resuming a run
        from a stage checkpoint must continue the Thm 4.1 accounting from
        the exact counters it stopped at, not restart them from zero."""
        for f in dataclasses.fields(self):
            if f.name in snap:
                setattr(self, f.name, type(getattr(self, f.name))(snap[f.name]))

    @classmethod
    def from_snapshot(cls, snap: dict) -> "DataAccessMeter":
        meter = cls()
        meter.restore(snap)
        return meter

    @classmethod
    def combined(cls, meters) -> "DataAccessMeter":
        """Sum counters across meters — the multi-host runtime reduces one
        per-host meter per plane (plus a global access meter) into the
        global Thm 4.1 accounting this way."""
        total = cls()
        for m in meters:
            for f in dataclasses.fields(cls):
                setattr(total, f.name,
                        getattr(total, f.name) + getattr(m, f.name))
        return total


# ------------------------------------------------------------------- stores
class ShardStore:
    """A pre-permuted corpus split into fixed-size shards.

    Shard i holds examples [i*shard_size, min((i+1)*shard_size, N)); every
    shard is full-size except possibly the last.  ``load`` returns exactly
    the real examples (no padding)."""
    shard_size: int
    num_examples: int
    item_shape: tuple
    dtype: np.dtype

    @property
    def num_shards(self) -> int:
        return -(-self.num_examples // self.shard_size)

    @property
    def example_nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * np.prod(self.item_shape,
                                                           dtype=np.int64))

    def examples_in(self, shard: int) -> int:
        if not 0 <= shard < self.num_shards:
            raise IndexError(shard)
        return min(self.shard_size,
                   self.num_examples - shard * self.shard_size)

    def shards_covering(self, n: int) -> range:
        """Shard ids needed so the first ``n`` examples are loadable."""
        n = max(0, min(n, self.num_examples))
        return range(0, -(-n // self.shard_size))

    def load(self, shard: int) -> np.ndarray:
        raise NotImplementedError


class InMemoryShardStore(ShardStore):
    """Shard interface over a resident array (synthetic corpora, tests)."""

    def __init__(self, data: np.ndarray, shard_size: int):
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        self._data = np.asarray(data)
        self.shard_size = int(shard_size)
        self.num_examples = int(self._data.shape[0])
        self.item_shape = tuple(self._data.shape[1:])
        self.dtype = self._data.dtype

    def load(self, shard: int) -> np.ndarray:
        k = self.examples_in(shard)           # bounds-checks ``shard``
        lo = shard * self.shard_size
        return np.array(self._data[lo: lo + k])


class MemmapShardStore(ShardStore):
    """One ``.npy`` file per shard plus a ``meta.json`` — the on-disk layout
    of the streaming plane.  Reads go through ``np.load(mmap_mode="r")`` and
    are materialized, so ``load`` measures real file I/O."""

    META = "meta.json"

    def __init__(self, directory: str):
        self.directory = str(directory)
        with open(os.path.join(self.directory, self.META)) as fh:
            meta = json.load(fh)
        self.shard_size = int(meta["shard_size"])
        self.num_examples = int(meta["num_examples"])
        self.item_shape = tuple(meta["item_shape"])
        self.dtype = np.dtype(meta["dtype"])

    @classmethod
    def open(cls, directory: str, *, validate: bool = True
             ) -> "MemmapShardStore":
        """Open an existing shard directory, checking every shard file's
        size against the recorded shape/dtype.  A missing or short file
        raises ``ShardLoadError`` naming the shard up front — instead of a
        numpy reshape error halfway through training when the prefetcher
        first touches it."""
        store = cls(directory)
        if validate:
            for i in range(store.num_shards):
                store._validate_shard(i)
        return store

    def _validate_shard(self, shard: int) -> None:
        """Size-check shard ``shard``'s file: header bytes plus exactly
        ``examples_in(shard) * example_nbytes`` of payload."""
        path = self._shard_path(self.directory, shard)
        try:
            size = os.path.getsize(path)
        except OSError as exc:
            raise ShardLoadError(shard, exc) from exc
        expected = self.examples_in(shard) * self.example_nbytes
        if size < expected:
            raise ShardLoadError(
                shard, f"{path} holds {size} bytes, needs at least "
                       f"{expected} for {self.examples_in(shard)} examples "
                       f"of {self.item_shape} {self.dtype} (truncated?)")

    @staticmethod
    def _shard_path(directory: str, shard: int) -> str:
        return os.path.join(directory, f"shard_{shard:05d}.npy")

    @classmethod
    def write(cls, data: np.ndarray, directory: str,
              shard_size: int) -> "MemmapShardStore":
        """Split a pre-permuted array into shard files under ``directory``."""
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        data = np.asarray(data)
        os.makedirs(directory, exist_ok=True)
        n = data.shape[0]
        for i in range(-(-n // shard_size)):
            lo = i * shard_size
            np.save(cls._shard_path(directory, i),
                    data[lo: lo + shard_size])
        meta = {"shard_size": int(shard_size), "num_examples": int(n),
                "item_shape": list(data.shape[1:]), "dtype": str(data.dtype)}
        with open(os.path.join(directory, cls.META), "w") as fh:
            json.dump(meta, fh)
        return cls(directory)

    def load(self, shard: int) -> np.ndarray:
        self.examples_in(shard)               # bounds-check
        path = self._shard_path(self.directory, shard)
        try:
            mm = np.load(path, mmap_mode="r")
        except (OSError, ValueError) as exc:
            # a corrupt .npy header / vanished file surfaces as the storage
            # failure it is, with the shard named, not a numpy parse error
            raise ShardLoadError(shard, exc) from exc
        if mm.shape != (self.examples_in(shard),) + self.item_shape:
            raise ShardLoadError(
                shard, f"{path} has shape {mm.shape}, expected "
                       f"{(self.examples_in(shard),) + self.item_shape}")
        return np.array(mm)                   # force the read off disk


class ThrottledStore(ShardStore):
    """A store with an artificial per-shard read latency, modelling the
    constrained-disk regime of §3.3 so overlap is measurable at CI scale."""

    def __init__(self, inner: ShardStore, delay_s: float):
        self._inner = inner
        self.delay_s = float(delay_s)
        self.shard_size = inner.shard_size
        self.num_examples = inner.num_examples
        self.item_shape = inner.item_shape
        self.dtype = inner.dtype

    def load(self, shard: int) -> np.ndarray:
        out = self._inner.load(shard)
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        return out
