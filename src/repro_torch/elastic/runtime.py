"""The elastic multi-host BET runtime: lanes survive workers — the port
of ``repro.elastic.runtime``.

The paper's resource argument (§3.3, Fig. 5) makes BET uniquely cheap to
run elastically: the stage window is a prefix of one fixed permutation, so
``(t, n_t)`` plus the ownership map fully determines what any replacement
worker must re-read — nothing else in the cluster holds state a recovery
needs.  This module exploits that with two complementary mechanisms, both
of which preserve the append-only local-prefix invariant that makes
expansion reshuffle-free:

  * **lane handover + rebuild** (host loss) — lanes are the durable unit;
    workers merely *drive* them.  When a worker dies, each of its lanes is
    adopted by the least-burdened survivor, the lane's device memory is
    reset (a real failure destroys it), and a fresh streaming plane
    re-reads **only that lane's owned slice of the current window** from
    storage.  Surviving lanes are untouched: zero re-upload, zero re-read,
    and the rebuilt lane is byte-identical to the uninterrupted run — so
    the optimization trajectory is unchanged.
  * **tail reassignment** (stragglers, joins) — shards wholly beyond the
    resident window may move between lanes freely: every moved id sorts
    after every landed shard on both sides, so landed prefixes stay valid
    and nothing resident moves (``dist.ownership.ElasticOwnership``).  The
    deadline-based stage flush uses this to migrate a slow worker's
    not-yet-loaded next-expansion shards to the fastest lane, after
    cancelling any in-flight loads whose local→global mapping the delta
    would invalidate (``Prefetcher.cancel``).

``ElasticBetEngine`` drives both from the engine's once-per-stage boundary
hook — exactly where a real deployment observes membership changes —
applying a ``FaultPlan`` (elastic/faults.py) deterministically for tests
and benchmarks.

On the card a lane rebuild zeroes the lane and appends its re-read rows on
the current stream, as every append does, so the next stage's kernels,
queued behind them, read the rebuilt lane.  The reference's ``recorder``
hooks (an instant per elastic event, mirrored into the host's fleet lane)
come with ``obs/`` (ROADMAP queue A11) and are left out here.
"""
from __future__ import annotations

import dataclasses
import math
import time

from ..core.engine import StageInfo
from ..data.shards import ShardStore
from ..dist.ownership import ElasticOwnership, OwnedShardStore
from ..dist.runtime import DistributedBetEngine, DistributedDataset
from ..dist.topology import SimulatedTopology
from .faults import FaultPlan


class _WorkerChannel(ShardStore):
    """A lane's storage channel through its *driving worker*.

    Per-worker read-latency heterogeneity (straggler hosts) is looked up at
    read time through the live lane→worker assignment, so handing a lane to
    a fast worker immediately speeds its loads, and slowing a worker slows
    every lane it drives.  Size metadata delegates to the underlying
    ``OwnedShardStore`` so elastic ownership refreshes show through."""

    def __init__(self, owned: OwnedShardStore, lane: int,
                 runtime: "ElasticDataset"):
        self._owned = owned
        self._lane = lane
        self._runtime = runtime
        self.item_shape = owned.item_shape
        self.dtype = owned.dtype

    @property
    def shard_size(self) -> int:
        return self._owned.shard_size

    @property
    def num_examples(self) -> int:
        return self._owned.num_examples

    def load(self, shard: int):
        out = self._owned.load(shard)
        delay = self._runtime.worker_delays.get(
            self._runtime.assignment[self._lane], 0.0)
        if delay > 0:
            time.sleep(delay)
        return out


class ElasticDataset(DistributedDataset):
    """``DistributedDataset`` whose lane→worker assignment is mutable.

    Without faults it behaves identically to its base (same ownership, same
    loads, same views); ``lose_host`` / ``slow_host`` / ``rejoin_host`` and
    the deadline flush ``rebalance_stragglers`` are the elastic surface the
    engine's stage boundary drives.  ``capacity_slack`` preallocates lane
    headroom so tail reassignment can grow a lane past its initial owned
    slice (reassignment refuses moves that would overflow a lane)."""

    def __init__(self, stores, *, topology=None, num_hosts=None,
                 ownership=None, growth: float = 2.0,
                 prefetch_workers: int = 1, capacity_slack: float = 1.0,
                 worker_delays=None):
        stores = tuple(stores)
        if topology is None:
            topology = SimulatedTopology(num_hosts or 1)
        # elastic state must exist before super().__init__ builds the
        # per-lane planes through our _lane_stores override
        lanes = range(topology.num_hosts)
        self.assignment = {lane: lane for lane in lanes}
        self.alive = set(lanes)
        self.worker_delays = dict(worker_delays or {})
        self.events: list[dict] = []
        self._owned: dict[int, list[OwnedShardStore]] = {}
        self._pace_base: dict[int, tuple] = {}
        if not stores:
            raise ValueError("ElasticDataset needs at least one store")
        if ownership is None:
            ownership = ElasticOwnership.for_store(stores[0],
                                                   topology.num_hosts)
        elif not isinstance(ownership, ElasticOwnership):
            ownership = ElasticOwnership.from_ownership(ownership)
        if not capacity_slack >= 1.0:
            raise ValueError(
                f"capacity_slack must be >= 1, got {capacity_slack}")
        cap = min(ownership.num_examples,
                  int(math.ceil(ownership.max_owned_examples
                                * capacity_slack)))
        super().__init__(stores, topology=topology, num_hosts=num_hosts,
                         ownership=ownership, growth=growth,
                         prefetch_workers=prefetch_workers,
                         lane_capacity=cap)

    def _lane_stores(self, lane: int) -> list:
        owned = [OwnedShardStore(s, self.ownership, lane)
                 for s in self.stores]
        self._owned[lane] = owned
        return [_WorkerChannel(o, lane, self) for o in owned]

    # ------------------------------------------------------------ membership
    def lose_host(self, worker: int, *, n_t: int) -> dict:
        """Worker ``worker`` died: hand each of its lanes to the
        least-burdened survivor and rebuild them from storage.

        The rebuild re-reads exactly the lane's owned slice of the current
        window ``[0, n_t)`` — the recovery bound the benchmark asserts —
        and touches no surviving lane (zero resident re-upload).  Ownership
        is unchanged, so the rebuilt lane is byte-identical to what the
        lost worker held and the trajectory continues as if nothing
        happened."""
        if worker not in self.alive:
            raise ValueError(f"worker {worker} is not alive")
        survivors = self.alive - {worker}
        if not survivors:
            raise RuntimeError(
                "cannot lose the last alive worker: no survivor can adopt "
                "its lanes")
        self.alive = survivors
        lanes = [l for l, w in self.assignment.items() if w == worker]
        rec = {"kind": "kill", "worker": worker, "lanes": []}
        for lane in lanes:
            # the lost worker's load channel is gone: close the plane,
            # dropping every in-flight prefetch it had outstanding
            self.planes[lane].close()
            burden = {w: 0 for w in survivors}
            for l, w in self.assignment.items():
                if w in burden:
                    burden[w] += 1
            adopter = min(survivors, key=lambda w: (burden[w], w))
            self.assignment[lane] = adopter
            for sw in self.stacked:
                sw.reset_lane(lane)     # device memory died with the host
            m = self.host_meters[lane]
            before = (m.examples_loaded, m.bytes_loaded, m.bytes_uploaded)
            self.planes[lane] = self._make_plane(lane)
            k = self.ownership.examples_in_prefix(lane, n_t)
            self.planes[lane].ensure_resident(k)
            rec["lanes"].append({
                "lane": lane, "adopted_by": adopter, "window": k,
                "owned_examples": self.ownership.num_owned_examples(lane),
                "reread_examples": m.examples_loaded - before[0],
                "reread_bytes": m.bytes_loaded - before[1],
                "rebuild_upload_bytes": m.bytes_uploaded - before[2],
            })
        self._counts_cache.clear()
        self.events.append(rec)
        return rec

    def slow_host(self, worker: int, delay_s: float) -> dict:
        """Worker ``worker``'s storage path degraded to ``delay_s`` per
        shard read (failing NIC, contended NAS) — every lane it drives
        inherits the latency through its ``_WorkerChannel``."""
        self.worker_delays[worker] = float(delay_s)
        rec = {"kind": "slow", "worker": worker, "delay_s": float(delay_s)}
        self.events.append(rec)
        return rec

    def rejoin_host(self, worker: int) -> dict:
        """Worker ``worker`` is back (or a fresh replacement registered):
        it adopts one lane from the most-burdened survivor.  A pure
        handover of driving responsibility — the lane's device buffer and
        residency bookkeeping are intact, so no storage is re-read (on a
        real pod this is a device-to-device lane migration)."""
        if worker in self.alive:
            raise ValueError(f"worker {worker} is already alive")
        self.alive.add(worker)
        self.worker_delays.pop(worker, None)    # fresh host, fresh channel
        burden: dict[int, list] = {}
        for lane, w in self.assignment.items():
            burden.setdefault(w, []).append(lane)
        donor, donor_lanes = max(burden.items(),
                                 key=lambda kv: (len(kv[1]), -kv[0]))
        rec = {"kind": "rejoin", "worker": worker, "lane": None,
               "from_worker": None}
        if len(donor_lanes) > 1:
            lane = max(donor_lanes)
            self.assignment[lane] = worker
            rec.update(lane=lane, from_worker=donor)
        self.events.append(rec)
        return rec

    # ------------------------------------------------------------ stragglers
    def _lane_pace(self, lane: int) -> float:
        """Seconds per shard read on this lane since the last flush (its
        lifetime average until one full inter-flush window has passed) —
        measured, so the deadline logic needs no knowledge of which worker
        was slowed."""
        m = self.host_meters[lane]
        cur = (m.load_time_s, m.loads)
        base = self._pace_base.get(lane, (0.0, 0))
        dt, dn = cur[0] - base[0], cur[1] - base[1]
        if dn > 0:
            return dt / dn
        return m.load_time_s / max(1, m.loads)

    def rebalance_stragglers(self, n_t: int, n_next: int | None,
                             deadline_s: float) -> list[dict]:
        """Deadline-based stage flush: if a lane's pending next-expansion
        backlog will not drain within ``deadline_s`` at its measured read
        pace, migrate the tail of that backlog to the fastest other lane.

        Only shards wholly beyond the resident window move (the
        ``ElasticOwnership.reassign`` contract), and pending loads whose
        local→global mapping the delta invalidates are cancelled first on
        both sides — an in-flight load for a migrated shard must never land
        at the stale window offset."""
        if n_next is None:
            return []
        boundary = -(-n_t // self.ownership.shard_size)
        paces = {lane: self._lane_pace(lane) for lane in self.planes}
        self._pace_base = {
            lane: (self.host_meters[lane].load_time_s,
                   self.host_meters[lane].loads) for lane in self.planes}
        out = []
        for lane, plane in self.planes.items():
            pending = sorted(plane.pending_shards())
            pace = paces[lane]
            if not pending or pace <= 0 or len(pending) * pace <= deadline_s:
                continue
            target = min((l for l in self.planes if l != lane),
                         key=lambda l: (paces[l], l))
            if paces[target] >= pace:
                continue                # nobody is faster; nothing to gain
            keep = int(deadline_s // pace)
            owned = self._owned[lane][0]
            gids = [owned.global_shard(i) for i in pending[keep:]]
            gids = [g for g in gids if g >= boundary]
            # lane headroom on the target: move only what fits
            free = self.lane_capacity - \
                self.ownership.num_owned_examples(target)
            while gids and sum(
                    min(self.ownership.shard_size,
                        self.ownership.num_examples
                        - g * self.ownership.shard_size)
                    for g in gids) > free:
                gids.pop()
            if len(gids) >= owned.num_shards:
                gids = gids[:-1]        # a lane must keep >= 1 shard
            if not gids:
                continue
            tplane = self.planes[target]
            towned = self._owned[target][0]
            # cancel stale pending loads on both sides, then mutate
            plane.drop_pending(owned.local_index(min(gids)))
            tplane.drop_pending(max(tplane.next_shard,
                                    towned.local_index(min(gids))))
            self.ownership.reassign(lane, target, gids, min_shard=boundary)
            for o in self._owned[lane] + self._owned[target]:
                o.refresh()
            self._counts_cache.clear()
            # re-schedule both lanes' shares of the next window under the
            # refreshed local→global mapping
            plane.prefetch(self.ownership.examples_in_prefix(lane, n_next))
            tplane.prefetch(self.ownership.examples_in_prefix(target, n_next))
            rec = {"kind": "rebalance", "from_lane": lane, "to_lane": target,
                   "shards": [int(g) for g in gids],
                   "pace_s_per_shard": round(pace, 6),
                   "backlog": len(pending), "deadline_s": deadline_s}
            self.events.append(rec)
            out.append(rec)
        return out

    # ------------------------------------------------------------ accounting
    def host_stage_records(self, n_t: int) -> list[dict]:
        records = super().host_stage_records(n_t)
        for r in records:
            r["worker"] = self.assignment[r["host"]]
        return records

    def elastic_state(self) -> dict:
        """Checkpointable elastic maps (JSON-safe): who drives which lane,
        who is alive, each lane's owned-shard list."""
        return {
            "assignment": [self.assignment[l]
                           for l in range(self.topology.num_hosts)],
            "alive": sorted(self.alive),
            "worker_delays": {str(w): d
                              for w, d in self.worker_delays.items()},
            "owned_shards": [self.ownership.owned_shards(l).tolist()
                             for l in range(self.topology.num_hosts)],
        }

    def restore_elastic_state(self, state: dict) -> None:
        """Inverse of ``elastic_state`` on a freshly constructed dataset —
        a resumed run must rebuild lanes under the *checkpointed* ownership
        (earlier deltas included), not the strategy default."""
        if any(p.resident for p in self.planes.values()):
            raise RuntimeError(
                "restore_elastic_state must run before any residency: "
                "landed lanes would not match the restored ownership")
        restored = ElasticOwnership(
            state["owned_shards"], self.ownership.shard_size,
            self.ownership.num_examples, strategy=self.ownership.strategy)
        if restored.max_owned_examples > self.lane_capacity:
            raise ValueError(
                f"checkpointed ownership needs lanes of "
                f"{restored.max_owned_examples} examples but this dataset "
                f"preallocated {self.lane_capacity}: the checkpointed run "
                f"had rebalanced lanes — resume with the same "
                f"capacity_slack / straggler flags it ran with")
        self.assignment = {l: int(w)
                           for l, w in enumerate(state["assignment"])}
        self.alive = set(int(w) for w in state["alive"])
        self.worker_delays = {int(w): float(d)
                              for w, d in state["worker_delays"].items()}
        self.ownership = restored
        self._owned.clear()
        for lane in list(self.planes):
            self.planes[lane].close()
            self.planes[lane] = self._make_plane(lane)
        self._counts_cache.clear()


@dataclasses.dataclass
class ElasticBetEngine(DistributedBetEngine):
    """``DistributedBetEngine`` plus the elastic stage boundary: after each
    stage's records flush (and after the ``stage_callback`` checkpoint, so
    a checkpoint always captures the healthy pre-fault state), the deadline
    flush rebalances stragglers and the ``FaultPlan``'s events for the
    completed stage are applied.  Every event lands in
    ``trace.meta["elastic_events"]``."""
    faults: FaultPlan | None = None
    deadline_s: float | None = None

    def _stage_boundary(self, ctx, info: StageInfo, w, state) -> None:
        super()._stage_boundary(ctx, info, w, state)    # checkpoint first
        dataset = ctx["dataset"]
        if not isinstance(dataset, ElasticDataset):
            if self.faults or self.deadline_s is not None:
                raise TypeError(
                    "fault injection / straggler deadlines require an "
                    f"ElasticDataset, got {type(dataset).__name__}")
            return
        events = []
        if self.deadline_s is not None:
            events.extend(dataset.rebalance_stragglers(
                info.n_t, info.n_next, self.deadline_s))
        if self.faults:
            for ev in self.faults.at(info.stage):
                if ev.kind == "kill":
                    events.append(dataset.lose_host(ev.host, n_t=info.n_t))
                elif ev.kind == "slow":
                    events.append(dataset.slow_host(ev.host, ev.delay_s))
                else:
                    events.append(dataset.rejoin_host(ev.host))
        if events:
            ctx["trace"].meta.setdefault("elastic_events", []).append(
                {"stage": info.stage, "n_t": info.n_t, "events": events})

    def run(self, dataset, optimizer, objective, policy, **kw):
        trace = super().run(dataset, optimizer, objective, policy, **kw)
        if isinstance(dataset, ElasticDataset):
            trace.meta.setdefault("dist", {})["elastic"] = \
                dataset.elastic_state()
        return trace
