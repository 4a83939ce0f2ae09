"""Host topology — who the hosts are and which devices each one drives;
the port of ``repro.dist.topology``.

The paper's distributed claim (§3.3, Fig. 5) is about *hosts*: each worker
keeps its resident data and streams in only its share of every expansion.
The runtime is written against a ``HostTopology`` protocol with two
implementations:

  * ``ProcessTopology`` — one ``torch.distributed`` process per host (NCCL
    on the card, gloo on the CPU); this process drives only its own host
    and its own device.
  * ``SimulatedTopology`` — N *logical* hosts in one process, over the
    torch device pool.  With one card every lane lives on it; the
    ownership and collective math is that of N real hosts, only placement
    differs.

The reference's ``hosts_mesh`` and ``window_sharding`` (a ``('hosts',)``
mesh and a ``NamedSharding`` that put lane h on host h's device) become
the question "which device holds lane h": ``devices_for(h)[0]``.  In one
process the stacked window (``data/device_window.StackedDeviceWindow``) is
one tensor, so it lives on ``window_device()``, the first local host's
device, as the reference's lanes do when the pool has no device per host.
The reference's ``force_host_device_flag`` is an XLA flag (N CPU devices
in one process) and has no counterpart.

Topologies ask for devices at construction, never on import."""
from __future__ import annotations

import torch

from ..device import resolve_device


class HostTopology:
    """Protocol: the set of hosts and the devices backing each one."""

    @property
    def num_hosts(self) -> int:
        raise NotImplementedError

    @property
    def local_hosts(self) -> tuple:
        """Hosts this process drives: all of them when simulated, exactly
        one under a real multi-process runtime."""
        raise NotImplementedError

    def devices_for(self, host: int) -> tuple:
        raise NotImplementedError

    def window_device(self) -> torch.device:
        """The device that holds this process's stacked window: the first
        local host's device."""
        return self.devices_for(self.local_hosts[0])[0]

    def describe(self) -> dict:
        """Where each local host's lane lives: the stacked window is one
        tensor, so on ``window_device()`` for every lane."""
        return {"kind": type(self).__name__, "num_hosts": self.num_hosts,
                "local_hosts": list(self.local_hosts),
                "devices": {h: [str(self.window_device())]
                            for h in self.local_hosts}}


class SimulatedTopology(HostTopology):
    """N logical hosts over this process's device pool.

    ``devices`` defaults to every CUDA card (raising without one, as every
    entry point of the port does; pass ``devices=("cpu",)`` for the CPU).
    ``devices_for`` gives the reference's grouping: with ``len(devices) >=
    num_hosts`` the pool is split into contiguous per-host groups,
    otherwise hosts share devices cyclically.  The grouping places nothing
    yet: every lane of the stacked window lives on ``window_device()``, the
    first host's first device; splitting lanes across devices needs one
    process a host (ROADMAP F1)."""

    def __init__(self, num_hosts: int, *, devices=None):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        self._num_hosts = int(num_hosts)
        if devices is None:
            resolve_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self._devices = tuple(resolve_device(d) for d in devices)
        if not self._devices:
            raise ValueError("SimulatedTopology needs at least one device")

    @property
    def num_hosts(self) -> int:
        return self._num_hosts

    @property
    def local_hosts(self) -> tuple:
        return tuple(range(self._num_hosts))

    def devices_for(self, host: int) -> tuple:
        if not 0 <= host < self._num_hosts:
            raise IndexError(host)
        n_dev = len(self._devices)
        if n_dev >= self._num_hosts:
            per = n_dev // self._num_hosts
            return self._devices[host * per: (host + 1) * per]
        return (self._devices[host % n_dev],)


class ProcessTopology(HostTopology):
    """One ``torch.distributed`` process per host.  This process is host
    ``get_rank()`` of ``get_world_size()``; its device is ``cuda:{local
    rank}`` (the rank modulo the cards of the machine), or ``device`` when
    given (``"cpu"`` under gloo).  Remote devices are not addressable from
    here, so ``devices_for`` answers only for the local host.

    The caller starts the process group (nothing on the card's machine
    tells a program of a cluster): ``torch.distributed.init_process_group(
    backend, init_method="tcp://HOST:PORT", world_size=N, rank=r)``."""

    def __init__(self, *, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessTopology needs an initialized torch.distributed "
                "process group: call torch.distributed.init_process_group("
                "'nccl' (or 'gloo' on the CPU), init_method=..., "
                "world_size=..., rank=...) first")
        self._index = dist.get_rank()
        self._count = dist.get_world_size()
        if device is None:
            resolve_device("cuda")
            device = f"cuda:{self._index % torch.cuda.device_count()}"
        self._device = resolve_device(device)

    @property
    def num_hosts(self) -> int:
        return self._count

    @property
    def local_hosts(self) -> tuple:
        return (self._index,)

    def devices_for(self, host: int) -> tuple:
        if host != self._index:
            raise ValueError(
                f"host {host} is remote; process {self._index} can only "
                f"address its local devices")
        return (self._device,)
