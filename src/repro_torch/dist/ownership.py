"""Shard → host ownership — who loads what, and why expansion never
reshuffles.

BET's §3.3 resource contract is that stage windows are nested prefixes of
one fixed permutation.  In the distributed setting (abstract, Fig. 5) each
host must additionally (a) load **only its own slice** of every expansion
and (b) never re-read or reshuffle data it already holds.  Both follow from
one structural property of the ownership map: host ``h``'s owned shards,
listed in ascending global order, meet any global shard prefix ``[0, q)`` in
a *prefix of that list*.  Growing the global window therefore only ever
**appends** to every host's local window — the local windows are themselves
nested prefixes, exactly the single-host invariant, per host.

Strategies:

  * ``striped`` (default) — ``owner(shard) = shard % num_hosts``.  Every
    global prefix splits nearly evenly (±1 shard per host), so all hosts
    stream and compute proportionally at **every** stage — the balance the
    paper's parallel experiment relies on.
  * ``blocked`` — contiguous ranges of shards per host.  Same nesting
    invariant (ownership lists are still ascending) but early stages live
    entirely on host 0; kept for layouts where block-locality of storage
    dominates (e.g. one NAS volume per host) and documented as unbalanced.

The port's copy of ``repro.dist.ownership``, line for line.  Numpy-only on
import (like data/shards.py): ``partition`` lazily imports the torch-backed
``HostWindows`` view."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..data.shards import ShardStore, store_capacity

STRATEGIES = ("striped", "blocked")


class OwnershipAlgebra:
    """The prefix algebra every ownership flavor shares.

    Implementations provide ``num_shards / num_hosts / shard_size /
    num_examples`` attributes and ``owned_shards(host) -> ascending global
    shard ids``; everything the runtime needs — per-host window sizes,
    local↔global index maps, the stacked eval view — follows from those."""

    def _shard_lengths(self, ids: np.ndarray) -> np.ndarray:
        return np.minimum(self.shard_size,
                          self.num_examples - ids * self.shard_size)

    def owned_shards(self, host: int) -> np.ndarray:
        raise NotImplementedError

    def num_owned_examples(self, host: int) -> int:
        return int(self._shard_lengths(self.owned_shards(host)).sum())

    @property
    def max_owned_examples(self) -> int:
        """Common lane capacity: the most examples any host owns (lanes are
        padded to this, masked by per-host valid counts)."""
        return max(self.num_owned_examples(h) for h in range(self.num_hosts))

    # ---------------------------------------------------------- prefix algebra
    def examples_in_prefix(self, host: int, n: int) -> int:
        """How many of host ``host``'s examples fall in the global prefix
        ``[0, n)`` — the host's local window size for stage window n.  Sums
        to ``n`` over hosts and is monotone in ``n`` (prefix nesting)."""
        n = max(0, min(int(n), self.num_examples))
        ids = self.owned_shards(host)
        lens = self._shard_lengths(ids)
        covered = np.clip(n - ids * self.shard_size, 0, lens)
        return int(covered.sum())

    def min_full_participation_window(self) -> int:
        """The smallest global window at which *every* host owns at least
        one example — below this, some lanes are empty and per-host batch
        composition (dist/collectives.rotation_batch) has nothing real to
        serve.  Monotonicity of ``examples_in_prefix`` makes the property
        permanent once reached, so validating ``n0`` against this validates
        the whole schedule."""
        return max(int(self.owned_shards(h)[0]) * self.shard_size + 1
                   for h in range(self.num_hosts))

    def local_to_global(self, host: int) -> np.ndarray:
        """Global example indices of host ``host``'s local window, in local
        order (ascending — local windows are prefixes of this)."""
        ids = self.owned_shards(host)
        lens = self._shard_lengths(ids)
        return np.concatenate([
            np.arange(s * self.shard_size, s * self.shard_size + k)
            for s, k in zip(ids, lens)]) if len(ids) else np.empty(0, np.int64)

    def partition(self, arrays, *, device="cuda") -> "HostWindows":
        """Stack pre-permuted field arrays into the per-host view on
        ``device``: one ``(num_hosts, max_owned, *item)`` zero-padded lane
        tensor per field plus the per-host valid counts.  Used for
        eval/full-data views and for asserting what the streaming runtime
        must reproduce."""
        import torch
        from ..data.device_window import HostWindows
        from ..device import resolve_device
        device = resolve_device(device)
        if isinstance(arrays, np.ndarray) or not isinstance(arrays,
                                                            (tuple, list)):
            arrays = (arrays,)
        cap = self.max_owned_examples
        counts = np.array([self.num_owned_examples(h)
                           for h in range(self.num_hosts)], np.int32)
        fields = []
        for a in arrays:
            a = np.asarray(a)
            stacked = np.zeros((self.num_hosts, cap) + a.shape[1:], a.dtype)
            for h in range(self.num_hosts):
                idx = self.local_to_global(h)
                stacked[h, : len(idx)] = a[idx]
            fields.append(torch.from_numpy(stacked).to(device))
        return HostWindows(tuple(fields), host_counts=counts.tolist())


@dataclasses.dataclass(frozen=True)
class ShardOwnership(OwnershipAlgebra):
    """The shard→host map plus the prefix algebra the runtime needs."""
    num_shards: int
    num_hosts: int
    shard_size: int
    num_examples: int
    strategy: str = "striped"

    def __post_init__(self):
        if self.num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {self.num_hosts}")
        if self.shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {self.shard_size}")
        if self.num_shards < self.num_hosts:
            raise ValueError(
                f"{self.num_hosts} hosts over {self.num_shards} shards: "
                f"every host must own at least one shard — lower num_hosts "
                f"or shrink shard_size")
        if -(-self.num_examples // self.shard_size) != self.num_shards:
            raise ValueError(
                f"num_shards={self.num_shards} inconsistent with "
                f"{self.num_examples} examples at shard_size="
                f"{self.shard_size}")
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; pick from {STRATEGIES}")

    @classmethod
    def for_store(cls, store: ShardStore, num_hosts: int,
                  strategy: str = "striped") -> "ShardOwnership":
        """Sized at the store's eventual ``capacity`` when it has one (an
        online store still ingesting): the map is fixed once at the bound,
        so data arrival only ever *appends* to each host's local window and
        the prefix invariant extends to a corpus discovered at runtime."""
        n = store_capacity(store)
        return cls(num_shards=-(-n // store.shard_size), num_hosts=num_hosts,
                   shard_size=store.shard_size,
                   num_examples=n, strategy=strategy)

    # ----------------------------------------------------------------- basics
    def owner(self, shard: int) -> int:
        if not 0 <= shard < self.num_shards:
            raise IndexError(shard)
        if self.strategy == "striped":
            return shard % self.num_hosts
        return min(self.num_hosts - 1, shard * self.num_hosts // self.num_shards)

    def owned_shards(self, host: int) -> np.ndarray:
        """Host ``host``'s shards as ascending global ids — the ascending
        order is what makes every global prefix a local prefix."""
        if not 0 <= host < self.num_hosts:
            raise IndexError(host)
        if self.strategy == "striped":
            return np.arange(host, self.num_shards, self.num_hosts)
        ids = np.arange(self.num_shards)
        return ids[np.minimum(self.num_hosts - 1,
                              ids * self.num_hosts // self.num_shards) == host]

class ElasticOwnership(OwnershipAlgebra):
    """Explicit per-host owned-shard lists supporting *prefix-safe deltas*.

    The elastic runtime's two ownership moves both preserve the invariant
    that makes expansion append-only:

      * **tail reassignment** (``reassign``) — moving shards whose global id
        lies entirely beyond the resident window between hosts.  Because
        every moved id sorts after *every* landed shard on both sides, the
        merged lists stay ascending and each host's landed shards remain
        exactly the leading prefix of its list: no resident row moves, no
        plane bookkeeping (``StreamingDataset.next_shard``) is invalidated.
        Used for straggler unloading and host joins.
      * **lane handover** (no ownership change at all) — a lost host's lane
        keeps its list and is rebuilt by a replacement host; see
        ``elastic/runtime.py``.

    Mutability is the point: the runtime mutates one shared instance and
    refreshes the ``OwnedShardStore`` views after cancelling any in-flight
    loads for migrated shards."""

    def __init__(self, lists, shard_size: int, num_examples: int,
                 strategy: str = "elastic"):
        lists = [np.asarray(l, np.int64).copy() for l in lists]
        num_shards = -(-num_examples // shard_size)
        seen = np.sort(np.concatenate(lists)) if lists else np.empty(0)
        if len(seen) != num_shards or \
                not np.array_equal(seen, np.arange(num_shards)):
            raise ValueError(
                f"owned-shard lists must partition range({num_shards})")
        for h, l in enumerate(lists):
            if len(l) == 0:
                raise ValueError(f"host {h} owns no shards")
            if not np.all(np.diff(l) > 0):
                raise ValueError(f"host {h}'s shard list is not ascending")
        self._lists = lists
        self.shard_size = int(shard_size)
        self.num_examples = int(num_examples)
        self.num_shards = int(num_shards)
        self.strategy = strategy

    @classmethod
    def from_ownership(cls, own: "ShardOwnership") -> "ElasticOwnership":
        return cls([own.owned_shards(h) for h in range(own.num_hosts)],
                   own.shard_size, own.num_examples,
                   strategy=f"elastic({own.strategy})")

    @classmethod
    def for_store(cls, store: ShardStore, num_hosts: int,
                  strategy: str = "striped") -> "ElasticOwnership":
        return cls.from_ownership(
            ShardOwnership.for_store(store, num_hosts, strategy))

    @property
    def num_hosts(self) -> int:
        return len(self._lists)

    def owner(self, shard: int) -> int:
        if not 0 <= shard < self.num_shards:
            raise IndexError(shard)
        for h, l in enumerate(self._lists):
            if shard in l:
                return h
        raise AssertionError(f"shard {shard} owned by no host")  # unreachable

    def owned_shards(self, host: int) -> np.ndarray:
        if not 0 <= host < self.num_hosts:
            raise IndexError(host)
        return self._lists[host].copy()

    # ------------------------------------------------------------------ deltas
    def reassign(self, src: int, dst: int, shard_ids, *,
                 min_shard: int) -> list[int]:
        """Move ``shard_ids`` from ``src`` to ``dst``.

        ``min_shard`` is the caller's residency boundary (the first global
        shard not intersecting any landed window, ``ceil(n_t/shard_size)``)
        — every moved id must be at or beyond it, which is what keeps both
        hosts' landed prefixes valid (see class docstring).  ``src`` must
        keep at least one shard so every lane stays non-empty.  Returns the
        moved ids, ascending."""
        ids = sorted(int(i) for i in shard_ids)
        if not ids:
            return []
        if src == dst:
            raise ValueError("reassign needs distinct src and dst hosts")
        for i in ids:
            if i < min_shard:
                raise ValueError(
                    f"shard {i} is below the residency boundary {min_shard}:"
                    f" moving it would reshuffle landed data")
            if i not in self._lists[src]:
                raise ValueError(f"shard {i} is not owned by host {src}")
        if len(self._lists[src]) - len(ids) < 1:
            raise ValueError(
                f"reassigning {len(ids)} shards would leave host {src} "
                f"with no shards")
        keep = np.setdiff1d(self._lists[src], ids)
        self._lists[src] = keep
        self._lists[dst] = np.union1d(self._lists[dst],
                                      np.asarray(ids, np.int64))
        return ids


class OwnedShardStore(ShardStore):
    """Host-local view of a global store: the host's owned shards as a
    dense local store (local shard ``j`` = global shard ``owned[j]``), so a
    per-host ``StreamingDataset``/``Prefetcher`` runs completely unchanged
    while physically reading **only owned shards**.

    Valid because ownership lists are ascending and only the globally-last
    shard may be ragged — so every non-final local shard is full-size, the
    base-class shard arithmetic carries over verbatim."""

    def __init__(self, inner: ShardStore, ownership: ShardOwnership,
                 host: int):
        cap = store_capacity(inner)
        if inner.shard_size != ownership.shard_size or \
                cap != ownership.num_examples:
            raise ValueError(
                f"store ({cap} examples / shard_size "
                f"{inner.shard_size}) does not match ownership "
                f"({ownership.num_examples} / {ownership.shard_size})")
        self._inner = inner
        self._ownership = ownership
        self._ids = ownership.owned_shards(host)
        self.host = host
        self.shard_size = inner.shard_size
        self.num_examples = ownership.num_owned_examples(host)
        self.item_shape = inner.item_shape
        self.dtype = inner.dtype

    def refresh(self) -> None:
        """Re-pull the owned-shard list after an elastic ownership delta.
        Deltas are tail-only (beyond everything already landed), so local
        ids below the plane's ``next_shard`` keep their meaning; the
        runtime cancels pending loads for any local id at or beyond the
        first edited position *before* mutating the ownership."""
        self._ids = self._ownership.owned_shards(self.host)
        self.num_examples = self._ownership.num_owned_examples(self.host)

    def local_index(self, global_shard: int) -> int:
        """Position of ``global_shard`` in this host's local order (or where
        it would insert) — the cancellation boundary for a pending-load
        sweep around an ownership delta."""
        return int(np.searchsorted(self._ids, int(global_shard)))

    def global_shard(self, local: int) -> int:
        """The global shard id behind local shard ``local``."""
        return int(self._ids[local])

    def load(self, shard: int) -> np.ndarray:
        self.examples_in(shard)               # bounds-check local id
        return self._inner.load(int(self._ids[shard]))
