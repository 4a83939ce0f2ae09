"""The multi-host BET runtime: per-host streaming planes over owned shards,
one stacked window, and a collective once-per-stage flush — the port of
``repro.dist.runtime``.

``DistributedDataset`` implements the engine's dataset protocol
(``n`` / ``window`` / ``begin_stage`` / ``note_access``) as N hosts:

  * each host gets **one StreamingDataset + Prefetcher** over
    ``OwnedShardStore`` views, so it physically reads only its owned shards
    (host i's bytes ≈ global/N) and prefetches only its slice of the next
    expansion while the current stage computes (§3.3, per host);
  * all hosts' windows are lanes of one ``StackedDeviceWindow`` per field,
    on the topology's device, grown in place, so the stage view
    ``HostWindows`` costs no device work and resident lanes are never
    re-uploaded; the view carries its lanes' counts on the host (from the
    ownership) and on the device (made once per window size);
  * per-host ``DataAccessMeter``s record each host's real I/O; the global
    Thm 4.1 accounting is their sum plus the engine's access charges
    (``DataAccessMeter.combined``).

``DistributedBetEngine`` is the ``BetEngine`` with the distributed flush:
stages still run on the device with the single-host run's host
transfers, and at each stage end the per-host records (window size,
loads, uploads) are all-gathered **once** through the communicator —
never per step — and landed in ``trace.meta["host_stage_records"]``.
With a recorder wired (``ObsSpec``), each rebuilt plane's prefetcher
emits into its host's lane, and the flush emits ``stage.host_records``
and, under fleet obs, a ``fleet.barrier`` in every lane."""
from __future__ import annotations

import dataclasses

import torch

from ..core.engine import BetEngine, StageInfo
from ..data.device_window import HostWindows, StackedDeviceWindow, \
    _device_ints
from ..data.plane import StreamingDataset
from ..data.shards import DataAccessMeter
from .collectives import Collectives, StackedCollectives
from .ownership import OwnedShardStore, ShardOwnership
from .topology import HostTopology, SimulatedTopology


class DistributedDataset:
    """Device-resident expanding windows sharded over hosts by ownership.

    Under a ``ProcessTopology`` each process runs its own host's plane
    alone, but still allocates the whole ``(H, capacity)`` stack, and its
    views count every host's rows: only ``DistributedObjective(comm=
    ProcessCollectives())``, which maps this process's lane and
    all-reduces, reads them right.  ``build`` refuses that path over
    several processes until it is wired end to end (ROADMAP queue A13)."""

    def __init__(self, stores, *, topology: HostTopology | None = None,
                 num_hosts: int | None = None,
                 ownership: ShardOwnership | None = None,
                 growth: float = 2.0, prefetch_workers: int = 1,
                 lane_capacity: int | None = None):
        stores = tuple(stores)
        if not stores:
            raise ValueError("DistributedDataset needs at least one store")
        if topology is None:
            topology = SimulatedTopology(num_hosts or 1)
        elif num_hosts is not None and num_hosts != topology.num_hosts:
            raise ValueError(f"num_hosts={num_hosts} contradicts topology "
                             f"with {topology.num_hosts} hosts")
        self.topology = topology
        self.stores = stores
        self.growth = growth
        self.prefetch_workers = prefetch_workers
        self.ownership = ownership or ShardOwnership.for_store(
            stores[0], topology.num_hosts)
        if self.ownership.num_hosts != topology.num_hosts:
            raise ValueError(
                f"ownership spans {self.ownership.num_hosts} hosts, "
                f"topology {topology.num_hosts}")
        self.host_meters = tuple(DataAccessMeter()
                                 for _ in range(topology.num_hosts))
        self._access = DataAccessMeter()        # engine's optimizer touches
        # lane_capacity > max_owned leaves headroom for elastic tail
        # reassignment (a lane may grow past its initial owned slice)
        cap = lane_capacity if lane_capacity is not None \
            else self.ownership.max_owned_examples
        if cap < self.ownership.max_owned_examples:
            raise ValueError(
                f"lane_capacity={cap} below the largest owned slice "
                f"({self.ownership.max_owned_examples})")
        self.lane_capacity = cap
        self.device = topology.window_device()
        self.stacked = tuple(
            StackedDeviceWindow(
                num_hosts=topology.num_hosts, capacity=cap,
                item_shape=s.item_shape, dtype=s.dtype, growth=growth,
                meters=self.host_meters, meter_examples=i == 0,
                device=self.device)
            for i, s in enumerate(stores))
        self.planes = {}
        for h in topology.local_hosts:
            self.planes[h] = self._make_plane(h)
        self._counts_cache: dict[int, torch.Tensor] = {}

    # --------------------------------------------------------- plane factory
    def _lane_stores(self, lane: int) -> list:
        """Per-lane store views (one per field).  The elastic runtime
        overrides this to wrap each owned store with the driving worker's
        read-latency model."""
        return [OwnedShardStore(s, self.ownership, lane) for s in self.stores]

    def _make_plane(self, lane: int) -> StreamingDataset:
        """One streaming plane for lane ``lane`` over its owned shards —
        also the lane *rebuild* path: a fresh plane over a reset lane
        re-reads exactly the lane's owned slice."""
        plane = StreamingDataset(
            self._lane_stores(lane), meter=self.host_meters[lane],
            growth=self.growth, prefetch_workers=self.prefetch_workers,
            windows=[sw.lane(lane) for sw in self.stacked])
        # re-wire observability onto rebuilt planes: the meter object
        # survives a lane rebuild (stays wrapped), the Prefetcher does not;
        # under fleet obs the rebuilt prefetcher emits into its host's lane
        rec = getattr(self, "_obs_recorder", None)
        if rec is not None:
            lane_of = getattr(rec, "lane", None)
            plane.prefetcher.recorder = \
                lane_of(lane) if lane_of is not None else rec
            plane.prefetcher.recorder_tags = {"host": int(lane)}
        return plane

    # ---------------------------------------------------------------- protocol
    @property
    def n(self) -> int:
        return self.stores[0].num_examples

    @property
    def d(self) -> int:
        return self.stores[0].item_shape[0]

    @property
    def resident(self) -> int:
        """Examples resident across local hosts (shard-rounded >= n_t)."""
        return sum(p.resident for p in self.planes.values())

    @property
    def meter(self) -> DataAccessMeter:
        """Global Thm 4.1 accounting: per-host real I/O plus access charges."""
        return DataAccessMeter.combined(
            [self.host_meters[h] for h in self.planes] + [self._access])

    def _make_resident(self, n_t: int) -> None:
        """Schedule every host's missing loads *before* blocking on any of
        them — otherwise host 1's prefetch pool sits idle while host 0's
        cold-start loads drain, and stage-0 blocked time scales with the
        host count instead of overlapping across hosts."""
        for h, plane in self.planes.items():
            plane.prefetch(self.ownership.examples_in_prefix(h, n_t))
        for h, plane in self.planes.items():
            plane.ensure_resident(self.ownership.examples_in_prefix(h, n_t))

    def begin_stage(self, n_t: int, n_next: int | None = None):
        """Stage setup on every local host: residency for its owned slice of
        ``[0, n_t)``, then overlap the *next* expansion's owned-shard loads
        with this stage's compute."""
        self._make_resident(n_t)
        if n_next is not None:
            for h, plane in self.planes.items():
                plane.prefetch(self.ownership.examples_in_prefix(h, n_next))
        return self._view(n_t)

    def window(self, n_t: int):
        self._make_resident(n_t)
        return self._view(n_t)

    def note_access(self, examples: int) -> None:
        self._access.record_access(examples)

    def close(self) -> None:
        for plane in self.planes.values():
            plane.close()

    def __enter__(self) -> "DistributedDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ views
    def _view(self, n_t: int) -> HostWindows:
        counts = [self.ownership.examples_in_prefix(h, n_t)
                  for h in range(self.topology.num_hosts)]
        dev = self._counts_cache.get(n_t)
        if dev is None:
            dev = self._counts_cache[n_t] = _device_ints(counts, self.device)
        return HostWindows(tuple(sw.buffer for sw in self.stacked), dev,
                           host_counts=counts)

    def full_windows(self) -> HostWindows:
        """The whole corpus as a ``HostWindows`` (forces full residency) —
        the distributed f̂ eval view when no separate eval set is given."""
        return self.window(self.n)

    # ------------------------------------------------------------- accounting
    def host_stage_records(self, n_t: int) -> list[dict]:
        """This process's per-host records for the stage flush: cumulative
        counters, so consecutive stages difference into per-stage deltas."""
        out = []
        for h, plane in self.planes.items():
            m = self.host_meters[h]
            out.append({
                "host": h, "window": self.ownership.examples_in_prefix(h, n_t),
                "resident": plane.resident,
                "examples_loaded": m.examples_loaded,
                "bytes_loaded": m.bytes_loaded,
                "examples_uploaded": m.examples_uploaded,
                "bytes_uploaded": m.bytes_uploaded,
                "blocked_time_s": round(m.blocked_time_s, 6),
            })
        return out


@dataclasses.dataclass
class DistributedBetEngine(BetEngine):
    """``BetEngine`` over a ``DistributedDataset``: the same stage execution
    on the device (policies, kernels, host transfers), plus the collective
    stage flush — per-host records all-gathered once per stage through
    ``comm`` — and global meter/topology accounting in the trace meta."""
    comm: Collectives = dataclasses.field(default_factory=StackedCollectives)

    def run(self, dataset, optimizer, objective, policy, **kw):
        if getattr(policy, "wants_variance", False) and \
                isinstance(dataset, DistributedDataset):
            raise NotImplementedError(
                "per-example variance policies are not SPMD-wired yet: "
                "variance_stats unpacks (X, y), not HostWindows")
        trace = super().run(dataset, optimizer, objective, policy, **kw)
        if isinstance(dataset, DistributedDataset):
            trace.meta["dist"] = {
                "topology": dataset.topology.describe(),
                "ownership": {
                    "strategy": dataset.ownership.strategy,
                    "num_shards": dataset.ownership.num_shards,
                    "shard_size": dataset.ownership.shard_size,
                },
                "host_meters": {h: dataset.host_meters[h].snapshot()
                                for h in dataset.planes},
                "meter": dataset.meter.snapshot(),
            }
        return trace

    def _collect_host_records(self, ctx, info: StageInfo) -> None:
        records = getattr(ctx["dataset"], "host_stage_records", None)
        if records is None:
            return
        gathered = self.comm.all_gather_records(records(info.n_t))
        ctx["trace"].meta.setdefault("host_stage_records", []).append(
            {"stage": info.stage, "n_t": info.n_t, "hosts": gathered})
        if self.recorder is not None:
            self.recorder.instant("stage.host_records", stage=info.stage,
                                  n_t=info.n_t, hosts=gathered)
            # the all-gather is the once-per-stage sync point every host
            # passes through — under fleet obs, mark it in every lane so
            # the merger can align per-host clocks (obs/fleet.py)
            barrier = getattr(self.recorder, "barrier", None)
            if barrier is not None:
                barrier(stage=info.stage, n_t=info.n_t)
