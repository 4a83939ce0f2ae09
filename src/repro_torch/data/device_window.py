"""The device-resident expanding window and its views — the port of the
reference's ``repro.data.device_window``.

``DeviceWindow`` is BET's data contract (§3.3): one device buffer,
allocated once at full capacity and grown **in place** as shards arrive,
so resident examples are never transferred again.  Two views:

  * ``masked(n)`` — a ``MaskedWindow``: the whole buffer plus a 0-d int32
    valid length on the buffer's device; consumers index ``% n_valid`` on
    the device (the LM path), so a step never reads the length back,
  * ``slice(n)`` — the prefix ``buf[:n]`` (the convex path, whose
    objectives reduce over the leading axis; bit-exact against slicing
    the same rows on the host path).

The multi-host half: ``StackedDeviceWindow`` holds one ``(H, capacity,
*item)`` buffer per field whose lane h is host h's expanding window,
``WindowLane`` is one lane seen as a ``DeviceWindow`` by that host's
streaming plane, and ``HostWindows`` is the stage view over all lanes.

The adapters ``rotation_rows``, ``probe_rows`` and ``rolling_subwindow``
take a plain window, a ``MaskedWindow`` or a ``HostWindows``;
``as_host_windows`` lifts any view to lanes.  ``append_staged`` comes with
the tiered corpus (ROADMAP queue A11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .shards import DataAccessMeter


@dataclasses.dataclass
class MaskedWindow:
    """A fixed-capacity row buffer with a device-side valid length: an
    expansion changes only ``n_valid``, never the buffer's shape."""
    data: torch.Tensor          # (capacity, *item_shape)
    n_valid: torch.Tensor       # () int32, on data's device

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def window_rows(data):
    """(rows, n) for either a ``MaskedWindow`` or a plain row tensor — the
    one adapter consumers need to run unchanged on both data paths."""
    if isinstance(data, MaskedWindow):
        return data.data, data.n_valid
    return data, data.shape[0]


def rotation_rows(data, batch_size: int, t):
    """The inner step's mini-batch: ``batch_size`` rows rotating through
    the window's valid prefix, ``(arange(B) + t·B) % n`` (sequential
    epochs over resident data — no random disk access).  ``t`` may be a
    device tensor, and ``n`` is one for a ``MaskedWindow``: the indices are
    then made on the device and the step never syncs.  The host path's
    slice and the plane's ``MaskedWindow`` gather the same rows.

    On a ``HostWindows`` each lane gives ``batch_size // H`` rows rotating
    through *its own* valid prefix, concatenated in lane order: the global
    batch of data parallelism.  Every lane must be non-empty (a device
    count cannot raise here): callers keep windows at or above
    ``OwnershipAlgebra.min_full_participation_window()``."""
    if isinstance(data, HostWindows):
        rows, per = data.fields[0], batch_size // data.num_hosts
        idx = (torch.arange(per, device=rows.device)[None, :] + t * per) \
            % data.counts[:, None]
        return _lane_rows(rows, idx)
    rows, n = window_rows(data)
    idx = (torch.arange(batch_size, device=rows.device) + t * batch_size) % n
    return rows[idx]


def probe_rows(data, rows: int):
    """A deterministic ``rows``-row measurement probe: the window's first
    rows, wrapping when the valid prefix is smaller.  On a ``HostWindows``:
    an equal share of each lane's valid prefix (wrapping when a lane is
    smaller), concatenated and cut to ``rows``; every lane non-empty, as
    for ``rotation_rows``."""
    if isinstance(data, HostWindows):
        lanes = data.fields[0]
        per = -(-rows // data.num_hosts)
        idx = torch.arange(per, device=lanes.device)[None, :] \
            % data.counts[:, None]
        return _lane_rows(lanes, idx)[:rows]
    buf, n = window_rows(data)
    return buf[torch.arange(rows, device=buf.device) % n]


def rolling_subwindow(data, fraction: float, t: int):
    """Rolling contiguous sub-window of a stage view — the Newton-CG
    Hessian subsample (decorrelates Hessian error across iterations
    without re-loading anything; BET's no-resampling property concerns
    *data access*, not in-memory slicing).  ``t`` is the optimizer's
    host-side step counter.

    A tuple of tensors sharing their leading (example) axis gives row
    views: ``k = round(fraction * n)`` rows from offset
    ``t * k mod (n - k + 1)``, the reference's offsets exactly.  A
    ``MaskedWindow`` gives a ``MaskedWindow`` of a static
    ``round(fraction * capacity)`` rows whose valid count is
    ``round(fraction * n_valid)`` (at least 1), from an offset kept inside
    both the valid prefix and the buffer — the reference's one-lane
    masked semantics, computed on the device.

    A ``HostWindows`` subsamples per *lane*: a static ``round(fraction *
    capacity)`` rows of each lane, from an offset computed on the host from
    the lane's host count, of which ``k_eff = round(fraction * m_h)``
    (clipped to [min(m_h, 1), m_h]) are valid, so an empty lane gives no
    row.  The rows are the reference's index for index: ``fraction * m_h``
    is rounded in float32, half to even, as ``jnp.round`` does it on an
    int32 count."""
    if isinstance(data, HostWindows):
        return _lane_subwindow(data, fraction, int(t))
    if isinstance(data, MaskedWindow):
        cap, m = data.capacity, data.n_valid
        k = max(1, int(round(fraction * cap)))
        k_eff = torch.clamp(torch.round(fraction * m.float()).int(),
                            torch.clamp(m, max=1), m)
        lim = torch.clamp(m - k_eff, max=cap - k)
        off = (t * torch.clamp(k_eff, min=1)) % torch.clamp(lim + 1, min=1)
        idx = off + torch.arange(k, device=data.data.device)
        return MaskedWindow(data.data[idx], k_eff)
    n = data[0].shape[0]
    k = max(1, int(round(fraction * n)))
    off = (int(t) * k) % max(1, n - k + 1)
    return tuple(x[off:off + k] for x in data)


def _lane_rows(lanes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx[h]`` of each lane h of ``lanes`` (H, capacity, ...),
    concatenated in lane order."""
    h = torch.arange(lanes.shape[0], device=lanes.device)[:, None]
    picked = lanes[h, idx]
    return picked.reshape((-1,) + tuple(picked.shape[2:]))


def _lane_subwindow(data: "HostWindows", fraction: float,
                    t: int) -> "HostWindows":
    if data.host_counts is None:
        raise ValueError("a lane subsample needs the lanes' host counts")
    cap = data.capacity
    k = max(1, int(round(fraction * cap)))
    offsets, counts = [], []
    for m in data.host_counts:
        k_eff = int(np.clip(np.round(np.float32(fraction) * np.float32(m)),
                            min(m, 1), m))
        lim = min(m - k_eff, cap - k)
        offsets.append((t * max(1, k_eff)) % max(1, lim + 1))
        counts.append(k_eff)
    return HostWindows(data.fields, host_counts=counts, host_offsets=offsets)


def as_host_windows(data) -> "HostWindows":
    """Lift any stage view to the stacked per-lane form: a ``HostWindows``
    passes through; a ``MaskedWindow`` becomes one lane with its device
    count (no host count: reading it would wait on the device); a plain row
    tensor, or a tuple of per-field tensors, one fully valid lane."""
    if isinstance(data, HostWindows):
        return data
    if isinstance(data, MaskedWindow):
        return HostWindows((data.data[None],),
                           data.n_valid.reshape(1).to(torch.int32))
    fields = tuple(data) if isinstance(data, (tuple, list)) else (data,)
    return HostWindows(tuple(f[None] for f in fields),
                       host_counts=(fields[0].shape[0],))


def _device_ints(values, device: torch.device) -> torch.Tensor:
    """An int32 tensor of ``values`` on ``device``; on the card copied from
    pinned memory without blocking, so making it never waits on the
    kernels queued before it."""
    host = torch.tensor(list(values), dtype=torch.int32)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


class HostWindows:
    """Stacked per-host masked windows — the stage view of the distributed
    expanding window (``dist/runtime.py``).

    ``fields`` is one ``(num_hosts, capacity, *item)`` tensor per data field
    (the convex path's X and y, the LM path's tokens); lane h holds host
    h's *owned* examples in its local, prefix-nested order.  Lanes are
    padded to a common capacity and hosts' valid lengths differ, so every
    consumer reads lane h through its count: ``counts``, the ``(H,)`` int32
    tensor on the fields' device (the LM gathers index with it and never
    read it back), and ``host_counts``, the same counts on the host where
    the maker of the view knows them without asking the device (the
    distributed dataset computes them from the ownership; the convex
    objective slices lanes with them).  Given only ``host_counts``, the
    device counts are made from them at first use.

    A lane's valid rows start at row 0, except in a lane subsample
    (``rolling_subwindow``), whose ``host_offsets`` say where each lane's
    rows start; such a view is read through ``lane`` alone, and has no
    device counts."""

    def __init__(self, fields, counts: torch.Tensor | None = None,
                 host_counts=None, host_offsets=None):
        if counts is None and host_counts is None:
            raise ValueError("HostWindows needs device or host counts")
        self.fields = tuple(fields)
        self._counts = counts
        self.host_counts = None if host_counts is None \
            else tuple(int(c) for c in host_counts)
        self.host_offsets = None if host_offsets is None \
            else tuple(int(o) for o in host_offsets)
        for per_lane in (self.host_counts, self.host_offsets):
            if per_lane is not None and len(per_lane) != self.num_hosts:
                raise ValueError(f"{len(per_lane)} per-lane values for "
                                 f"{self.num_hosts} lanes")

    @property
    def counts(self) -> torch.Tensor:
        if self.host_offsets is not None:
            raise ValueError("a lane subsample's rows start at its host "
                             "offsets; read it through lane(h)")
        if self._counts is None:
            self._counts = _device_ints(self.host_counts,
                                        self.fields[0].device)
        return self._counts

    def lane(self, h: int) -> tuple:
        """Lane h's valid rows of every field, as views (no copy)."""
        if self.host_counts is None:
            raise ValueError("reading a lane on the host needs its host "
                             "count; this view has device counts only")
        off = self.host_offsets[h] if self.host_offsets else 0
        return tuple(f[h, off:off + self.host_counts[h]]
                     for f in self.fields)

    @property
    def num_hosts(self) -> int:
        return self.fields[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.fields[0].shape[1]


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (a store's) or a torch dtype, as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _upload(dst: torch.Tensor, rows: np.ndarray) -> None:
    """Copy host ``rows`` into the device view ``dst`` without blocking: on
    the card from pinned memory, on the current stream, which every later
    kernel of the run is queued on, so no reader sees rows that have not
    landed.  The pinned block is not reused before the copy has run: the
    caching host allocator records the copy's stream."""
    src = torch.from_numpy(np.ascontiguousarray(rows)).to(dst.dtype)
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


@dataclasses.dataclass
class DeviceWindow:
    """Preallocated expanding window resident on ``device``.

    ``append`` uploads only the new rows and lands them after the
    resident prefix, so growing never re-uploads resident data.  On the
    card the rows are copied from pinned host memory with
    ``non_blocking=True`` on the current stream, the stream every later
    kernel of the run is queued on, so no reader can see rows that have
    not landed.  ``growth`` mirrors the stage schedule and is validated
    like ``BETSchedule.growth``.

    Views stay valid: an append writes only rows beyond the resident
    prefix, so a view handed out earlier keeps its rows and values (the
    reference, whose appends donate the buffer, must drop its views)."""
    capacity: int
    item_shape: tuple
    dtype: Any
    growth: float = 2.0
    meter: DataAccessMeter | None = None
    # multi-field planes (X, y) append the same example range to several
    # windows; only one of them counts *examples* uploaded (bytes are
    # genuinely per-field and always counted)
    meter_examples: bool = True
    device: Any = "cuda"

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if not self.growth > 1.0:
            raise ValueError(
                f"DeviceWindow.growth must be > 1, got {self.growth}: the "
                "window would never expand to its full capacity")
        self.item_shape = tuple(self.item_shape)
        self.device = resolve_device(self.device)
        self._buf = torch.zeros((self.capacity,) + self.item_shape,
                                dtype=_torch_dtype(self.dtype),
                                device=self.device)
        self._n = 0
        self._n_dev = self._scalar(0)

    def _scalar(self, n: int) -> torch.Tensor:
        # a fresh tensor each time: a MaskedWindow handed out earlier keeps
        # its own count
        return torch.full((), n, dtype=torch.int32, device=self.device)

    # ---------------------------------------------------------------- state
    @property
    def n_valid(self) -> int:
        return self._n

    @property
    def buffer(self) -> torch.Tensor:
        return self._buf

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def next_size(self) -> int:
        """The schedule's next window: n_{t+1} = min(cap, ceil(g * n_t))."""
        return min(self.capacity, int(math.ceil(max(1, self._n) * self.growth)))

    # --------------------------------------------------------------- updates
    def append(self, rows: np.ndarray) -> int:
        """Upload ``rows`` and land them in place after the resident prefix.
        Returns the new valid length."""
        rows = np.asarray(rows)
        if rows.shape[1:] != self.item_shape:
            raise ValueError(
                f"rows shape {rows.shape[1:]} != item shape {self.item_shape}")
        k = int(rows.shape[0])
        if self._n + k > self.capacity:
            raise ValueError(
                f"append of {k} rows overflows window "
                f"({self._n}/{self.capacity} resident)")
        _upload(self._buf[self._n:self._n + k], rows)
        if self.meter is not None:
            self.meter.record_upload(nbytes=rows.nbytes,
                                     examples=k if self.meter_examples else 0)
        self._n += k
        self._n_dev = self._scalar(self._n)
        return self._n

    # ---------------------------------------------------------------- cursor
    def cursor(self) -> dict:
        """Checkpointable residency bookkeeping: together with the fixed
        permutation, ``n_valid`` fully determines the window's contents."""
        return {"n_valid": self._n}

    def restore_cursor(self, cursor: dict) -> None:
        """Restore the valid-length bookkeeping from a checkpoint.  Pure
        cursor state: the caller re-lands the first ``n_valid`` examples
        beneath it (a resumed plane replays ``ensure_resident``)."""
        n = int(cursor["n_valid"])
        if not 0 <= n <= self.capacity:
            raise ValueError(
                f"cursor n_valid={n} outside window capacity {self.capacity}")
        self._n = n
        self._n_dev = self._scalar(n)

    # ----------------------------------------------------------------- views
    def masked(self, n: int | None = None) -> MaskedWindow:
        """Fixed-shape view exposing the first ``n`` (default: all resident)
        examples through the valid-length mask."""
        if n is None:
            return MaskedWindow(self._buf, self._n_dev)
        if n > self._n:
            raise ValueError(f"window {n} exceeds resident prefix {self._n}")
        return MaskedWindow(self._buf, self._scalar(n))

    def slice(self, n: int) -> torch.Tensor:
        """Device-side prefix view (the convex path's (X[:n], y[:n]))."""
        if n > self._n:
            raise ValueError(f"window {n} exceeds resident prefix {self._n}")
        return self._buf[:n]


# --------------------------------------------------- multi-host stacked window
@dataclasses.dataclass
class StackedDeviceWindow:
    """The multi-host ``DeviceWindow``: one ``(num_hosts, capacity,
    *item)`` buffer on ``device``, allocated once at capacity, whose lane h
    is host h's expanding window, grown in place by the same non-blocking
    copy from pinned memory as ``DeviceWindow.append``, so resident lanes
    are never re-uploaded.

    The reference places lane h on host h's device through a ``('hosts',)``
    mesh; in one torch process the stacked buffer is one tensor on the
    topology's device (``dist/topology.py``), where every simulated lane
    lives.  ``meters`` is an optional per-host ``DataAccessMeter`` sequence:
    a lane append charges its host's meter, which keeps per-host upload
    accounting separable in the global Thm 4.1 sum."""
    num_hosts: int
    capacity: int
    item_shape: tuple
    dtype: Any
    growth: float = 2.0
    meters: Any = None
    meter_examples: bool = True
    device: Any = "cuda"

    def __post_init__(self):
        if self.num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {self.num_hosts}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if not self.growth > 1.0:
            raise ValueError(
                f"StackedDeviceWindow.growth must be > 1, got {self.growth}")
        if self.meters is not None and len(self.meters) != self.num_hosts:
            raise ValueError(f"{len(self.meters)} meters for "
                             f"{self.num_hosts} hosts")
        self.item_shape = tuple(self.item_shape)
        self.device = resolve_device(self.device)
        self._buf = torch.zeros(
            (self.num_hosts, self.capacity) + self.item_shape,
            dtype=_torch_dtype(self.dtype), device=self.device)
        self._n = [0] * self.num_hosts

    @property
    def buffer(self) -> torch.Tensor:
        return self._buf

    @property
    def counts(self) -> np.ndarray:
        return np.asarray(self._n, np.int32)

    def lane_valid(self, host: int) -> int:
        return self._n[host]

    def next_size(self, host: int) -> int:
        """Lane ``host``'s next scheduled window size."""
        return min(self.capacity,
                   int(math.ceil(max(1, self._n[host]) * self.growth)))

    def append(self, host: int, rows: np.ndarray) -> int:
        """Upload ``rows`` into lane ``host`` after its resident prefix."""
        if not 0 <= host < self.num_hosts:
            raise IndexError(host)
        rows = np.asarray(rows)
        if rows.shape[1:] != self.item_shape:
            raise ValueError(
                f"rows shape {rows.shape[1:]} != item shape {self.item_shape}")
        k, n = int(rows.shape[0]), self._n[host]
        if n + k > self.capacity:
            raise ValueError(
                f"append of {k} rows overflows lane {host} "
                f"({n}/{self.capacity} resident)")
        _upload(self._buf[host, n:n + k], rows)
        if self.meters is not None:
            self.meters[host].record_upload(
                nbytes=rows.nbytes, examples=k if self.meter_examples else 0)
        self._n[host] += k
        return self._n[host]

    def reset_lane(self, host: int) -> None:
        """Forget lane ``host``'s resident prefix — the host-loss recovery
        primitive.  A real host failure destroys the lane's device memory,
        so the lane is zeroed as well as its cursor (on the current stream,
        ahead of the rebuild's appends): the replacement host must re-read
        the lane's owned slice from storage, and tests can prove it did."""
        if not 0 <= host < self.num_hosts:
            raise IndexError(host)
        self._buf[host].zero_()
        self._n[host] = 0

    def cursor(self) -> dict:
        """Checkpointable per-lane residency bookkeeping."""
        return {"counts": [int(n) for n in self._n]}

    def restore_cursor(self, cursor: dict) -> None:
        """Restore per-lane valid lengths (the contract of
        ``DeviceWindow.restore_cursor``: the caller re-lands the data)."""
        counts = [int(c) for c in cursor["counts"]]
        if len(counts) != self.num_hosts:
            raise ValueError(
                f"cursor has {len(counts)} lanes, window {self.num_hosts}")
        if any(not 0 <= c <= self.capacity for c in counts):
            raise ValueError(
                f"cursor counts {counts} outside capacity {self.capacity}")
        self._n = counts

    def lane(self, host: int) -> "WindowLane":
        return WindowLane(self, host)


class WindowLane:
    """One host's lane of a ``StackedDeviceWindow``, seen as a
    ``DeviceWindow`` by the residency bookkeeping of that host's streaming
    plane: this is what lets ``DistributedDataset`` drive one
    ``StreamingDataset`` per host while all lanes share one buffer."""

    def __init__(self, stacked: StackedDeviceWindow, host: int):
        if not 0 <= host < stacked.num_hosts:
            raise IndexError(host)
        self._stacked = stacked
        self.host = host

    @property
    def n_valid(self) -> int:
        return self._stacked.lane_valid(self.host)

    @property
    def buffer(self) -> torch.Tensor:
        return self._stacked.buffer

    def next_size(self) -> int:
        return self._stacked.next_size(self.host)

    def append(self, rows: np.ndarray) -> int:
        return self._stacked.append(self.host, rows)
